"""The train stem's backward (`ops/cuda_stem_train.py::stem_grad`, the kernel
`csrc/stem_grad.cu`) and its plain twin `stem_grad_plain`.

On the CPU: the twin against autograd through `reference_stem` given the
forward's moments, in float32 within 1e-5 of each gradient's largest entry,
with γ of both signs, tie-heavy inputs (flat regions), non-zero cotangents of
the mean and the variance, and over a process group of one; a numpy mirror of
the kernel's tile walk (its ownership of conv pixels, the 9×17 windows a tile
routes, the row-major first argmax and the window offsets each owned pixel
gathers from) against the twin's routed cotangent, bit for bit; and
`fused_train_stem`'s backward taking the twin on a CPU tensor.

On the card (marked `cuda`, skipped without a GPU; the file imports no JAX,
so it runs there with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_stem_grad.py -q`): the kernel against the twin and both
against autograd through `reference_stem`, at the edge shapes of the
persistent tile walk and at b16 640², in bf16 and float32, with dx asked
for and not: the routed position equal to the twin's at ≥ 99.9% of pooled
outputs; bf16 at cosine ≥ 0.999 for each output; float32 within 1e-4 of the
reference's largest entry, the kernel against the twin routed by the
kernel's routing and the twin against autograd (a few windows in millions
sit at near-ties of r that the kernel's conv and cuDNN's round apart, and a
cotangent routed apart moves the gradients by its worth); two launches and
a captured launch `torch.equal` to an eager one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch.ops import _build, stem_core
from dcfa_yolo_tpu_torch.ops import cuda_stem_train as cst

torch.set_num_threads(1)

EPS = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


def _inputs(seed, shape, dtype=F32, flat=False, cot=True, device="cpu"):
    """x (B, H, W, 3) in [0, 1] (quantised to quarters where `flat`: large
    flat regions, so r ties across a window), kernel, γ of both signs, β,
    gy and the moments' cotangents (zero unless `cot`)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, 3), np.float32)
    if flat:
        x = np.floor(x * 4) / 4
    k = (rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    gamma[:2] = (0.7, -0.7)  # both signs, whatever the seed
    beta = (rng.standard_normal(16) * 0.1).astype(np.float32)
    gy = rng.standard_normal((b, h // 2, w // 2, 16)).astype(np.float32)
    gm, gv = (rng.standard_normal((2, 16)) * 0.1 * cot).astype(np.float32)
    t = lambda a, dt=F32: torch.from_numpy(a).to(device, dt)
    return t(x, dtype), t(k), t(gamma), t(beta), t(gy, dtype), t(gm), t(gv)


def _moments(x, k, group=None):
    """The forward's (mean, mean²), as `_FusedTrainStem.forward` forms them
    from kernel C's (or its twin's) sums."""
    b, h, w, _ = x.shape
    sums = cst.stem_train(x.contiguous(), k.to(x.dtype).contiguous(), group)[2]
    n = b * h * w
    return sums[:, 0] / n, sums[:, 1] / n


def _reference(x, k, gamma, beta, gy, gm, gv, moments, group=None):
    """Autograd through `reference_stem` given the forward's moments."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, k, gamma, beta)]
    outs = cst.reference_stem(*leaves, EPS, group, moments)
    return torch.autograd.grad(outs, leaves, (gy, gm, gv))


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _cos(got, ref):
    return float(torch.nn.functional.cosine_similarity(
        got.double().flatten(), ref.double().flatten(), 0))


# -- the plain twin on the CPU ---------------------------------------------
@pytest.mark.parametrize("flat", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("cot", [False, True], ids=["gy", "gy-gmean-gvar"])
@pytest.mark.parametrize("shape", [(2, 16, 34), (1, 30, 18)])
def test_plain_twin_matches_autograd_f32(shape, cot, flat):
    x, k, gamma, beta, gy, gm, gv = _inputs(1, shape, flat=flat, cot=cot)
    moments = _moments(x, k)
    ref = _reference(x, k, gamma, beta, gy, gm, gv, moments)
    got = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    for name, g, r in zip(("dx", "dkernel", "dgamma", "dbeta"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))


@pytest.mark.parametrize("needs", [(True, True, True, True), (False, True, True, True),
                                   (False, False, True, True), (True, False, False, False)])
def test_plain_twin_returns_what_is_needed(needs):
    x, k, gamma, beta, gy, gm, gv = _inputs(2, (1, 16, 32))
    moments = _moments(x, k)
    full = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    got = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS, needs=needs)
    for need, g, f in zip(needs, got, full):
        assert (g is None) == (not need)
        if need:
            assert torch.equal(g, f)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_twin_routed_by_its_own_routing_is_unchanged(dtype):
    """`route` (the kernel's routing, as the card tests give it) routes as
    the twin's own first argmax does where it is the twin's own."""
    x, k, gamma, beta, gy, gm, gv = _inputs(10, (2, 30, 18), dtype, flat=True)
    moments = _moments(x, k)
    route = cst.route_plain(x, k, gamma, beta, *moments, EPS)
    assert (route == cst.NO_ROUTE).any() and (route != cst.NO_ROUTE).any()
    own = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    given = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS, route=route)
    assert all(torch.equal(a, b) for a, b in zip(own, given))


def test_plain_twin_bf16_is_close_to_autograd():
    """bf16: the twin rounds where the plain backward rounds (the pool's
    cotangent, dĉ, dW), so it stays within bf16 noise of autograd."""
    x, k, gamma, beta, gy, gm, gv = _inputs(3, (2, 32, 64), BF16, flat=True)
    moments = _moments(x, k)
    ref = _reference(x, k, gamma, beta, gy, gm, gv, moments)
    got = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    assert got[0].dtype == BF16 and got[1].dtype == F32
    for name, g, r in zip(("dx", "dkernel", "dgamma", "dbeta"), got, ref):
        assert _cos(g, r) >= 0.9999, (name, _cos(g, r))


def test_plain_twin_over_a_group_of_one(tmp_path):
    """With a gloo group of one the moments' cotangents are averaged over
    one rank: the twin equals itself without a group, and autograd through
    `reference_stem` with the group."""
    import torch.distributed as dist
    from dcfa_yolo_tpu_torch.parallel.mesh import init_process_group

    group = init_process_group("gloo", f"file://{tmp_path}/store", 0, 1, "cpu")
    try:
        x, k, gamma, beta, gy, gm, gv = _inputs(4, (1, 16, 34), cot=True)
        moments = _moments(x, k, group)
        ref = _reference(x, k, gamma, beta, gy, gm, gv, moments, group)
        got = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS, group)
        alone = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(g, a) for g, a in zip(got, alone))
    for name, g, r in zip(("dx", "dkernel", "dgamma", "dbeta"), got, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))


def test_fused_backward_takes_the_twin_on_the_cpu():
    x, k, gamma, beta, gy, gm, gv = _inputs(5, (2, 16, 32), cot=True)
    moments = _moments(x, k)
    leaves = [t.clone().requires_grad_(True) for t in (x, k, gamma, beta)]
    before = _build.launches()
    outs = cst.fused_train_stem(*leaves, EPS)
    got = torch.autograd.grad(outs, leaves, (gy, gm, gv))
    assert not _build.launches(before)
    twin = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    assert all(torch.equal(g, t) for g, t in zip(got, twin))


# -- a numpy mirror of the kernel's tile walk ----------------------------------
def _mirror_dy(c, r, gy, h, w):
    """dy (B, 16, H, W) as the kernel forms it: for each tile of 8×16
    pooled pixels, the first argmax of r in each of the 9×17 windows that
    cover its owned 16×32 conv pixels (kept where r > 0), then at each owned
    pixel the kept cotangents of the windows whose argmax offset is its own,
    in row-major window order, summed in float32.  Every conv pixel is owned
    once."""
    b = c.shape[0]
    hp, wp = h // 2, w // 2
    tiles_x, tiles_y, n = stem_core.tile_grid(b, h, w)
    dy = np.full((b, 16, h, w), np.nan, np.float32)
    for t in range(n):
        bi, pr0, pc0 = stem_core.tile_origin(t, tiles_x, tiles_y)
        keep = np.zeros((9, 17, 16), np.float32)
        at = np.full((9, 17, 16), 255, np.int64)
        for wr in range(9):
            for wc in range(17):
                pr, pc = pr0 + wr, pc0 + wc
                if pr >= hp or pc >= wp:
                    continue
                best = np.full(16, -np.inf, np.float32)
                for oy in range(3):
                    for ox in range(3):
                        yy, xx = 2 * pr - 1 + oy, 2 * pc - 1 + ox
                        if yy < 0 or xx < 0:
                            continue
                        v = r[bi, :, yy, xx]
                        better = v > best
                        best = np.where(better, v, best)
                        at[wr, wc] = np.where(better, oy * 3 + ox, at[wr, wc])
                keep[wr, wc] = np.where(best > 0, gy[bi, pr, pc], 0.0)
        for orow in range(16):
            for ocol in range(32):
                yy, xx = 2 * pr0 + orow, 2 * pc0 + ocol
                if yy >= h or xx >= w:
                    continue
                assert np.isnan(dy[bi, 0, yy, xx]), "a conv pixel owned twice"
                acc = np.zeros(16, np.float32)
                for i in range(1 + orow % 2):
                    for j in range(1 + ocol % 2):
                        off = ((2 - 2 * i) if orow % 2 else 1) * 3 + ((2 - 2 * j) if ocol % 2
                                                                      else 1)
                        wr, wc = orow // 2 + i, ocol // 2 + j
                        acc += np.where(at[wr, wc] == off, keep[wr, wc], np.float32(0))
                dy[bi, :, yy, xx] = acc
    assert not np.isnan(dy).any(), "a conv pixel no tile owns"
    return dy


@pytest.mark.parametrize("shape,flat", [((2, 30, 18), False), ((1, 34, 66), True),
                                        ((1, 16, 32), True)])
def test_kernel_tile_walk_routes_as_the_twin(shape, flat):
    x, k, gamma, beta, gy, _, _ = _inputs(6, shape, flat=flat)
    mean, mean2 = _moments(x, k)
    b, h, w, _ = x.shape
    c = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, padding=1)
    rstd = torch.rsqrt(torch.clamp_min(mean2 - mean * mean, 0.0) + EPS)
    r, idx = cst._route_plain(c, mean, rstd, gamma, beta, F32)
    want = torch.zeros((b * 16, h * w)).scatter_add_(
        1, idx.reshape(b * 16, -1), gy.permute(0, 3, 1, 2).reshape(b * 16, -1))
    want = (want.view(b, 16, h, w) * (r > 0)).numpy()
    got = _mirror_dy(c.numpy(), r.numpy(), gy.numpy(), h, w)
    np.testing.assert_array_equal(got, want)


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# chip_smoke.py's EDGE_SHAPES, then the main path's b16 640²
CARD_SHAPES = [(1, 640, 640), (3, 640, 640), (1, 320, 320), (3, 320, 320),
               (1, 1280, 1280), (2, 64, 130), (3, 30, 18), (1, 66, 66), (16, 640, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_twin_and_reference(cuda, shape, dtype):
    flat = shape[1] % 3 == 0 or shape[0] == 16  # ties on half the shapes, and on the main path
    x, k, gamma, beta, gy, gm, gv = _inputs(7, shape, dtype, flat=flat, device=cuda)
    moments = _moments(x, k)
    route = torch.empty(gy.shape, dtype=torch.uint8, device=cuda)
    before = _build.launches()
    got = cst.stem_grad(x, k, gamma, beta, *moments, gy, gm, gv, EPS, route=route)
    n = _build.launches(before)
    assert n["stem_grad"] == 3 and n["stem_grad_f32"] == 3 * (dtype == F32), n
    no_dx = cst.stem_grad(x, k, gamma, beta, *moments, gy, gm, gv, EPS,
                          needs=(False, True, True, True))
    assert no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], no_dx[1:]))
    twin = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS)
    routed = cst.stem_grad_plain(x, k, gamma, beta, *moments, gy, gm, gv, EPS, route=route)
    ref = _reference(x, k, gamma, beta, gy, gm, gv, moments)
    same = (route == cst.route_plain(x, k, gamma, beta, *moments, EPS)).float().mean().item()
    assert same >= 0.999, same
    # float32: where the kernel's conv and cuDNN's round a near-tie of r
    # apart (a few windows in millions), a cotangent lands on another pixel
    # and moves the gradients by its worth; so the kernel is held to the twin
    # routed as the kernel routed (the arithmetic), the twin to autograd
    # (both take ĉ from the same conv), and the routing to the share above
    for name, g, t, tr, r in zip(("dx", "dkernel", "dgamma", "dbeta"), got, twin, routed, ref):
        assert g.dtype == t.dtype and g.shape == t.shape and torch.isfinite(g).all(), name
        if dtype == F32:
            scale = r.abs().max()
            for a, b_ in ((g, tr), (t, r)):
                assert (a - b_).abs().max() <= 1e-4 * scale, (name, _rel(a, b_), same)
        else:
            assert _cos(g, t) >= 0.999 and _cos(g, r) >= 0.999, (name, _cos(g, t), _cos(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_kernel_runs_and_a_capture_are_equal(cuda, dtype):
    x, k, gamma, beta, gy, gm, gv = _inputs(8, (16, 640, 640), dtype, flat=True, device=cuda)
    moments = _moments(x, k)
    call = lambda: cst.stem_grad(x, k, gamma, beta, *moments, gy, gm, gv, EPS,
                                 needs=(False, True, True, True))
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first[1:], second[1:]))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        call()  # warm on the capture's stream
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.held_launches() as held:
        with torch.cuda.graph(graph):
            captured = call()
    assert held == ({"stem_grad": 2, "stem_grad_f32": 2} if dtype == F32 else {"stem_grad": 2})
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first[1:], captured[1:]))
