"""The train-mode BatchNorm: kernel D (`ops/cuda_bn_train.py`) and its
plain version (`ops/norm.py::BatchNorm.train_plain`).

On the CPU: the train branch of `BatchNorm.forward` equals the branch as it
was before kernel D (frozen below) bit for bit, in output, running
statistics and the gradients of x, γ and β, over the three dtype routes,
both layouts, both BN flavours and inside `recomputing()`, and launches
nothing; the checks a CUDA call must pass, D's refusal of a CPU tensor, and
D's plan.

On the card (marked `cuda`, skipped without a GPU; the file imports no JAX,
so it runs there with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_bn_train.py -q`): D against the plain version at the main
path's shapes (phi n, s and x layers at b16 640², the 80-channel 640² stem
BN down to the 20² layers): the bf16 output ≥ 99.9% bit-equal and every
other element within one bf16 step, `mean` and `rstd` within 1e-6, the
running statistics within 1e-6, dx at cosine ≥ 0.99999 and within 1e-4 of
its norm, γ's and β's gradients within 1e-5; two runs `torch.equal`; D's
launches over one captured phi-n step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch.ops import cuda_bn_train as cbt
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm, batch_moments, recomputing

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
ROUTES = [(F32, BF16), (BF16, BF16), (F32, F32)]
FLAVOURS = [(1e-3, 0.03), (1e-5, 0.1)]


def _seed_branch(bn: BatchNorm, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The train branch of `BatchNorm.forward` before kernel D, as it was."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    mean2 = (xf * xf).mean(dim=(0, 2, 3))
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    with torch.no_grad():
        m, n = bn.momentum, x.shape[0] * x.shape[2] * x.shape[3]
        bessel = n / max(n - 1.0, 1.0)
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean.detach())
        bn.running_var.copy_((1.0 - m) * bn.running_var + m * var.detach() * bessel)
    y = (xf - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y.to(dtype or x.dtype)


def _bn(c, eps, momentum, rng, device="cpu"):
    bn = BatchNorm(c, eps=eps, momentum=momentum).train()
    with torch.no_grad():
        for t, (s, m) in ((bn.weight, (0.3, 1.0)), (bn.bias, (0.2, 0.0)),
                          (bn.running_mean, (0.1, 0.0))):
            t.copy_(torch.from_numpy((rng.standard_normal(c) * s + m).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy((rng.random(c) + 0.5).astype(np.float32)))
    return bn.to(device)


def _input(shape, dtype, nhwc, rng, device="cpu"):
    """Per-channel offsets and scales, as a conv's sums have them: the
    offsets within a few standard deviations, where the plain version's
    float32 `mean2 − mean²` keeps its variance to about 1e-6 (a mean of k
    standard deviations costs it a factor 1 + k² of float32's 6e-8)."""
    n, c, h, w = shape
    off = rng.standard_normal((1, c, 1, 1)) * 0.5
    scale = rng.random((1, c, 1, 1)) * 2.0 + 0.5
    x = torch.from_numpy((rng.standard_normal(shape) * scale + off).astype(np.float32))
    x = x.to(device, dtype)
    return x.contiguous(memory_format=torch.channels_last) if nhwc else x


def _run(fn, bn, x, dtype, w):
    """fn(bn, x, dtype) forward and backward against weights w: (y, running
    mean, running var, dx, dγ, dβ)."""
    x = x.detach().clone().requires_grad_(True)
    bn.weight.grad = bn.bias.grad = None
    y = fn(bn, x, dtype)
    (y.float() * w).sum().backward()
    return (y.detach(), bn.running_mean.clone(), bn.running_var.clone(), x.grad,
            bn.weight.grad, bn.bias.grad)


# -- CPU: the plain route is the branch it replaced --------------------------
@pytest.mark.parametrize("route", ROUTES, ids=["f32-bf16", "bf16-bf16", "f32-f32"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("eps,momentum", FLAVOURS)
def test_plain_route_equals_the_seed_branch(route, nhwc, eps, momentum):
    x_dtype, y_dtype = route
    rng = np.random.default_rng(17)
    shape = (3, 16, 5, 6)
    x = _input(shape, x_dtype, nhwc, rng)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn_new = _bn(16, eps, momentum, rng)
    bn_old = _bn(16, eps, momentum, np.random.default_rng(17))
    bn_old.load_state_dict(bn_new.state_dict())
    before = cbt.LAUNCHES
    new = _run(lambda bn, x, dt: bn(x, dt), bn_new, x, y_dtype, w)
    old = _run(_seed_branch, bn_old, x, y_dtype, w)
    assert cbt.LAUNCHES == before
    assert new[0].dtype == y_dtype and new[3].dtype == x_dtype
    for a, b in zip(new, old):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_plain_route_inside_a_recompute_leaves_the_running_statistics(nhwc):
    rng = np.random.default_rng(5)
    shape = (2, 8, 4, 4)
    x = _input(shape, F32, nhwc, rng)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn = _bn(8, 1e-3, 0.03, rng)
    ref = _bn(8, 1e-3, 0.03, rng)
    ref.load_state_dict(bn.state_dict())
    start = bn.running_mean.clone(), bn.running_var.clone()
    with recomputing():
        got = _run(lambda bn, x, dt: bn(x, dt), bn, x, BF16, w)
    want = _run(_seed_branch, ref, x, BF16, w)
    assert torch.equal(got[1], start[0]) and torch.equal(got[2], start[1])
    for i in (0, 3, 4, 5):
        assert torch.equal(got[i], want[i])


def test_plain_version_equals_the_module():
    """`train_plain` called directly, as chip_smoke and the card tests call
    it on the card, is what the module's CPU route runs."""
    rng = np.random.default_rng(3)
    x = _input((2, 8, 3, 5), F32, False, rng)
    bn, ref = _bn(8, 1e-5, 0.1, rng), _bn(8, 1e-5, 0.1, rng)
    ref.load_state_dict(bn.state_dict())
    y = bn(x, BF16)
    y_plain = ref.train_plain(x, BF16)
    assert torch.equal(y, y_plain) and torch.equal(bn.running_var, ref.running_var)


# -- the checks before a launch, and the plan ----------------------------------
def _params(c, device="cpu"):
    return tuple(torch.ones(c, device=device) for _ in range(4))


@pytest.mark.parametrize("route", ROUTES, ids=["f32-bf16", "bf16-bf16", "f32-f32"])
def test_kernel_refuses_a_cpu_tensor(route):
    x = torch.zeros(2, 16, 4, 4, dtype=route[0])
    before = cbt.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cbt.bn_train(x, *_params(16), 0.03, 1e-3, route[1])
    assert cbt.LAUNCHES == before


@pytest.mark.parametrize("case", ["bf16-f32", "f16-f16", "f32-f16", "f64-f64", "strided",
                                  "sliced", "3d", "param-dtype", "param-shape", "channels"])
def test_check_route_refuses(case):
    x = torch.zeros(2, 16, 4, 4)
    dtype, params = BF16, _params(16)
    if case == "bf16-f32":
        x, dtype = x.to(BF16), F32
    elif case == "f16-f16":
        x, dtype = x.half(), torch.float16
    elif case == "f32-f16":
        dtype = torch.float16
    elif case == "f64-f64":
        x, dtype = x.double(), torch.float64
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "sliced":
        x = torch.zeros(2, 32, 4, 4)[:, ::2]
    elif case == "3d":
        x = x[0]
    elif case == "param-dtype":
        params = (params[0].double(),) + params[1:]
    elif case == "param-shape":
        params = params[:3] + (torch.ones(8),)
    elif case == "channels":
        x, params = torch.zeros(1, cbt.MAX_CHANNELS + 1, 1, 2), _params(cbt.MAX_CHANNELS + 1)
    with pytest.raises(ValueError):
        cbt.check_route(x, dtype, params)


@pytest.mark.parametrize("route", ROUTES, ids=["f32-bf16", "bf16-bf16", "f32-f32"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_check_route_takes_the_main_path(route, nhwc):
    x = torch.zeros(2, 16, 4, 4, dtype=route[0])
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    assert cbt.check_route(x, route[1], _params(16)) is nhwc


# the main path's shapes at b16 640² (phi n, s and x), and shapes whose
# contiguous axis 16 bytes do not divide
PLAN_SHAPES = [((16, 80, 640, 640), True, 2), ((16, 32, 640, 640), True, 2),
               ((16, 64, 320, 320), False, 4), ((16, 160, 160, 160), True, 4),
               ((16, 640, 20, 20), False, 4), ((16, 640, 20, 20), True, 4),
               ((16, 64, 20, 20), False, 2), ((16, 256, 20, 20), True, 2),
               ((3, 20, 7, 9), False, 4), ((2, 20, 9, 9), True, 2), ((1, 1, 1, 1), False, 4)]


@pytest.mark.parametrize("shape,nhwc,elem", PLAN_SHAPES)
def test_plan_covers_the_input_once(shape, nhwc, elem):
    p = cbt.plan(shape, nhwc, elem, True, 132)
    n, c, h, w = shape
    contiguous = c if nhwc else h * w
    assert p.vec in (1, 16 // elem) and contiguous % p.vec == 0
    assert p.vec == 16 // elem or contiguous % (16 // elem)
    assert p.nvec * p.vec == n * c * h * w
    assert 1 <= p.grid <= cbt.BLOCKS_PER_SM * 132
    if nhwc:
        rows = n * h * w
        assert 1 <= p.txn <= 32 and (p.chunks - 1) * p.chunk < rows <= p.chunks * p.chunk
    else:
        nv = n * h * w // p.vec
        assert (p.chunks - 1) * p.chunk < nv <= p.chunks * p.chunk
    blocks = p.chunks * (-(-(c // p.vec) // p.txn) if nhwc else c)
    assert blocks <= 2 * cbt.BLOCKS_PER_SM * 132
    if n * c * h * w >= 400_000:  # the smallest main-path layer fills the card
        assert blocks >= 132 and p.grid >= 132
    assert cbt.plan(shape, nhwc, elem, False, 132).vec == 1


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (shape, NHWC, x dtype, y dtype): phi x's and s's plain stems (NHWC bf16 at
# 640²), conv sums at every scale in both layouts, the smallest 20² layers,
# the float32 route, and shapes that take one element a load
CARD_SHAPES = [
    ((16, 80, 640, 640), True, BF16, BF16), ((16, 32, 640, 640), True, BF16, BF16),
    ((16, 64, 320, 320), False, F32, BF16), ((16, 160, 160, 160), True, F32, BF16),
    ((16, 320, 80, 80), False, F32, BF16), ((16, 320, 40, 40), True, BF16, BF16),
    ((16, 640, 20, 20), False, F32, BF16), ((16, 640, 20, 20), True, F32, BF16),
    ((16, 64, 20, 20), False, F32, BF16), ((16, 256, 20, 20), True, BF16, BF16),
    ((16, 128, 40, 40), False, F32, F32), ((8, 32, 160, 160), True, F32, F32),
    ((3, 20, 7, 9), False, F32, BF16), ((2, 20, 9, 9), True, BF16, BF16),
]


def _card_case(cuda, shape, nhwc, x_dtype, seed):
    rng = np.random.default_rng(seed)
    x = _input(shape, x_dtype, nhwc, rng, cuda)
    bn = _bn(shape[1], 1e-3, 0.03, rng, cuda)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    return x, bn, g


def _d_and_plain(bn, x, dtype, g):
    """D and the plain version from the same state: (D's, plain's) outputs
    of `_run` with the cotangent g."""
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    kern = _run(lambda m, xx, dt: cbt.bn_train(xx, m.weight, m.bias, m.running_mean,
                                               m.running_var, m.momentum, m.eps, dt),
                bn, x, dtype, g)
    bn.load_state_dict(state)
    plain = _run(lambda m, xx, dt: m.train_plain(xx, dt), bn, x, dtype, g)
    bn.load_state_dict(state)
    return kern, plain


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nhwc,x_dtype,y_dtype", CARD_SHAPES)
def test_kernel_matches_plain(cuda, shape, nhwc, x_dtype, y_dtype):
    x, bn, g = _card_case(cuda, shape, nhwc, x_dtype, sum(shape))
    before = cbt.LAUNCHES
    kern, plain = _d_and_plain(bn, x, y_dtype, g)
    torch.cuda.synchronize()
    assert cbt.LAUNCHES == before + 6
    (y, rm, rv, dx, dw, db), (y_p, rm_p, rv_p, dx_p, dw_p, db_p) = kern, plain
    assert y.dtype == y_dtype and y.stride() == x.stride() and dx.stride() == x.stride()
    gamma = bn.weight.abs().view(1, -1, 1, 1)
    if y_dtype == BF16:
        same = (y == y_p).float().mean().item()
        assert same >= 0.999, same
        # within one bf16 step (the larger value's), or, next to zero, where
        # the versions' moments (1e-6 apart) move more than a step, within
        # 1e-5 of γ
        step = torch.maximum(y.float().abs(), y_p.float().abs()) * 2.0**-7
        assert bool(((y.float() - y_p.float()).abs() <= torch.maximum(step, 1e-5 * gamma)).all())
    else:
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    # the moments, against float64 and the plain version's float32
    p = cbt.plan(tuple(x.shape), nhwc, x.element_size(), True, cbt._sms(x.device))
    scratch = bn.running_mean.clone(), bn.running_var.clone()
    stats = cbt._moments(x, p, bn.eps, scratch, False, bn.momentum, None)
    # given D's moments, the plain arithmetic gives D's output bit for bit
    shape = (1, -1, 1, 1)
    y_same = ((x.float() - stats[0].view(shape)) * stats[1].view(shape)
              * bn.weight.view(shape) + bn.bias.view(shape)).to(y_dtype)
    assert torch.equal(y, y_same)
    xd = x.double()
    mean64, var64 = xd.mean(dim=(0, 2, 3)), xd.var(dim=(0, 2, 3), unbiased=False)
    mean_p, var_p = batch_moments(x.float())
    rms = (var64 + mean64 ** 2).sqrt()
    assert torch.equal(scratch[0], bn.running_mean) and torch.equal(scratch[1], bn.running_var)
    assert float(((stats[0].double() - mean_p.double()).abs() / rms).max()) <= 1e-6
    rstd64 = (var64 + bn.eps).rsqrt()
    assert float(((stats[1].double() - rstd64).abs() / rstd64).max()) <= 1e-6
    rstd_p = torch.rsqrt(var_p + bn.eps).double()
    assert float(((stats[1].double() - rstd_p).abs() / rstd_p).max()) <= 1e-6
    torch.testing.assert_close(rm, rm_p, rtol=1e-6, atol=1e-6 * float(rm_p.abs().max()))
    torch.testing.assert_close(rv, rv_p, rtol=1e-6, atol=0.0)
    assert dx.dtype == x_dtype
    assert _cosine(dx, dx_p) >= 0.99999
    assert float((dx.double() - dx_p.double()).norm() / dx_p.double().norm()) <= 1e-4
    torch.testing.assert_close(dw, dw_p, rtol=1e-5, atol=1e-5 * float(dw_p.abs().max()))
    torch.testing.assert_close(db, db_p, rtol=1e-5, atol=1e-5 * float(db_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nhwc,x_dtype,y_dtype", [CARD_SHAPES[i] for i in (1, 3, 8, 13)])
def test_kernel_runs_are_equal(cuda, shape, nhwc, x_dtype, y_dtype):
    x, bn, g = _card_case(cuda, shape, nhwc, x_dtype, 7)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    runs = []
    for _ in range(2):
        bn.load_state_dict(state)
        runs.append(_run(lambda m, xx, dt: m(xx, dt), bn, x, y_dtype, g))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16-f32", "f16-f16", "strided"])
def test_kernel_wrapper_refuses_on_the_card(cuda, case):
    bn = BatchNorm(16).to(cuda).train()
    x = torch.zeros(2, 16, 4, 4, device=cuda)
    dtype = BF16
    if case == "bf16-f32":
        x, dtype = x.to(BF16), F32
    elif case == "f16-f16":
        x, dtype = x.half(), torch.float16
    else:
        x = x.transpose(2, 3)
    before = cbt.LAUNCHES
    with pytest.raises(ValueError):
        bn(x, dtype)
    assert cbt.LAUNCHES == before


@pytest.mark.cuda
def test_captured_phi_n_step_counts_its_bn_calls(cuda):
    """An eager phi-n step launches D six times for each train BN call (three
    forward, three backward); the captured step holds as many, and each
    replay adds them."""
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.parallel.dryrun import dry_batch
    from dcfa_yolo_tpu_torch.train.trainer import HELD_COUNTERS, WARMUP_STEPS, Trainer

    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(64, 64), compute_dtype="bfloat16")
    tr = Trainer(init_model(cfg, 0, cuda, train=True), TrainConfig(max_boxes=4), device=cuda)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append(1))
             for m in tr.model.modules() if isinstance(m, BatchNorm)]
    b = tr.put_batch(*dry_batch(4, (64, 64)))
    before = cbt.LAUNCHES
    tr.train_step(b, 1e-2)
    torch.cuda.synchronize()
    eager = cbt.LAUNCHES - before
    n_bn = len(calls)
    for h in hooks:
        h.remove()
    assert n_bn > 0 and eager == 6 * n_bn
    for _ in range(WARMUP_STEPS):  # the second warm-up step, then the capture
        tr.train_step(b, 1e-2)
    assert tr.graph_stats()["captures"] == 1
    held = dict(zip(HELD_COUNTERS, tr._graph.launches))
    assert held[(cbt, "LAUNCHES")] == eager
    before, replays = cbt.LAUNCHES, tr.graph_stats()["replays"]
    tr.train_step(b, 1e-2)
    torch.cuda.synchronize()
    assert cbt.LAUNCHES - before == eager
    assert tr.graph_stats()["replays"] == replays + 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES, ids=["f32-bf16", "bf16-bf16", "f32-f32"])
def test_kernel_over_a_group_of_one_equals_no_group(cuda, route, tmp_path):
    """SyncBN through D (the moments' all-reduce between its two finalizes,
    the cotangents' between the backward's finalize and apply) over an
    NCCL world of one gives, bit for bit, what D gives without a group."""
    import torch.distributed as dist

    from dcfa_yolo_tpu_torch.parallel.mesh import init_process_group

    x_dtype, y_dtype = route
    x, bn, g = _card_case(cuda, (8, 32, 40, 40), x_dtype == F32, x_dtype, 11)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    group = init_process_group("nccl", f"file://{tmp_path}/store", 0, 1, cuda)
    try:
        runs = []
        for grp in (group, None):
            bn.load_state_dict(state)
            bn.group = grp
            runs.append(_run(lambda m, xx, dt: m(xx, dt), bn, x, y_dtype, g))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
