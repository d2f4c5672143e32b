"""Port stem split probe (dcfa_yolo_tpu_torch/ops/cuda_stem_probe.py and
dcfa_yolo_tpu_torch/tools/stem_split_probe.py) against the JAX probe
`tools/stem_split_probe.call`, on the CPU: the Pallas kernels run in
interpret mode (`pl.pallas_call` patched with `interpret=True`), the port's
wrappers take their plain versions.

Both sides get the same zero-bordered canvas of a seeded uint8 image pair
and the same stem kernel and BN numbers, folded by each package's own
function: `fold_stem_params_d` (the v3 contract) for JAX,
`fold_stem_params` (the v4 contract) for the port.  Only the float32
summation order then differs, so 'full' is held in the v4 class
(tests/test_pallas_stem.py) and 'conv' against JAX 'dots' within one bf16
step; 'pool' has no JAX counterpart with a meaning (its `vpu` value is an
iota construct) and is held against a numpy evaluation of its own
definition.  `conv_gemm_probe`, 'conv' in the card kernel's GEMM form, is
held against `conv_plain` in the v4 class and against JAX 'dots' within one
bf16 step.  The card kernel of 'pool' is mirrored in numpy on kernel A's
staging and conv-tile layout (csrc/stem_core.cuh's EvalLayout and
EVAL_SCS) and held bitwise against `pool_plain` at ragged shapes.  The
sm_90 gate of `stem_probe` and of the probe's entry point is checked with
`torch.cuda.get_device_capability` monkeypatched.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tools.stem_split_probe as jprobe
from dcfa_yolo_tpu.ops.pallas_stem import fold_stem_params_d
from dcfa_yolo_tpu.ops.resize import deinterleave_cols_cf
from dcfa_yolo_tpu_torch.ops import _build, cuda_stem_probe as csp, stem_core
from dcfa_yolo_tpu_torch.ops.cuda_stem import fold_stem_params
from dcfa_yolo_tpu_torch.tools import stem_split_probe as probe

torch.set_num_threads(1)

B, S = 2, 32


@pytest.fixture(scope="module")
def stem_numbers():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (B, S, S, 3)).astype(np.float32)
    kern = rng.normal(0, 0.1, (3, 3, 3, 16)).astype(np.float32)  # HWIO
    gamma = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    var = (rng.random(16) + 0.5).astype(np.float32)
    # a zero BN shift, as in the JAX probe: the v3 contract keeps the bias in
    # float32 and the v4 one rounds it to bf16, which alone would move 12%
    # of the outputs by a bf16 step at these sizes
    beta = mean = np.zeros(16, np.float32)
    canvas = np.zeros((B, 3, S + 2, S + 2), np.float32)
    canvas[:, :, 1:-1, 1:-1] = img.transpose(0, 3, 1, 2)
    return canvas, kern, gamma, beta, mean, var


@pytest.fixture(scope="module")
def port_inputs(stem_numbers):
    canvas, kern, *bn = stem_numbers
    w, bias = fold_stem_params(torch.from_numpy(kern.transpose(3, 2, 0, 1)),
                               *(torch.from_numpy(x) for x in bn))
    return torch.from_numpy(canvas).to(torch.bfloat16), w, bias


@pytest.fixture
def jax_call(stem_numbers, monkeypatch):
    """variant → the JAX probe's output in interpret mode, NHWC float32."""
    monkeypatch.setattr(jprobe.pl, "pallas_call",
                        functools.partial(jprobe.pl.pallas_call, interpret=True))
    canvas, kern, *bn = stem_numbers
    wd3, bias3 = fold_stem_params_d(jnp.asarray(kern), *(jnp.asarray(x) for x in bn))
    x_cfd = deinterleave_cols_cf(jnp.asarray(canvas, jnp.bfloat16))

    def call(variant):
        out = np.asarray(jprobe.call(variant, S, x_cfd, wd3, bias3), np.float32)
        return out.transpose(0, 1, 3, 2)  # (B, H/2, 16, W/2) → NHWC
    return call


@pytest.mark.parametrize("variant", ["full", "dblbuf", "pipe"])
def test_full_plain_matches_jax(port_inputs, jax_call, variant):
    mine = csp.PLAIN["full"](*port_inputs).float().numpy()
    ref = jax_call(variant)
    np.testing.assert_allclose(mine, ref, atol=0.03, rtol=0.02)
    assert (mine == ref).mean() >= 0.999


def _within_one_bf16_step(mine, ref):
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(abs(mine), abs(ref)),
                                                2.0 ** -126))) - 7)
    assert np.all(np.abs(mine - ref) <= step)
    assert np.abs(mine).max() > 0.5  # a live conv, not a row of zeros


def test_conv_plain_matches_jax_dots(port_inputs, jax_call):
    """The conv sample at (2i, 2j) against JAX 'dots' (its even-row,
    even-column conv output), within one bf16 step of the larger value: the
    f32 sums run in another order before the bf16 rounding."""
    _within_one_bf16_step(csp.conv_plain(*port_inputs).float().numpy(), jax_call("dots"))


def test_conv_gemm_probe_matches_jax_dots(port_inputs, jax_call):
    """The card kernel's arithmetic for 'conv' (K = 32 GEMM, the bias in
    row 27) against JAX 'dots', at the tolerance of
    test_conv_plain_matches_jax_dots."""
    _within_one_bf16_step(csp.conv_gemm_probe(*port_inputs).float().numpy(),
                          jax_call("dots"))


def _stem_inputs(b, h, w, seed):
    """A raw 0..255 canvas and the folded weights of a random stem with a
    nonzero BN shift, so that the bias row carries a value."""
    rng = np.random.default_rng(seed)
    canvas = np.zeros((b, 3, h + 2, w + 2), np.float32)
    canvas[:, :, 1:-1, 1:-1] = rng.integers(0, 256, (b, 3, h, w))
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32))
    gamma, beta, mean = (torch.from_numpy((rng.standard_normal(16) * s + m).astype(np.float32))
                         for s, m in ((0.2, 1.0), (0.2, 0.0), (0.1, 0.0)))
    var = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    return (torch.from_numpy(canvas).to(torch.bfloat16),
            *fold_stem_params(k, gamma, beta, mean, var))


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 30, 18), (2, 64, 130), (1, 66, 66)])
def test_conv_gemm_probe_matches_conv_plain(shape):
    """In the v4 class (atol 0.03, rtol 0.02, >= 99.9% bit-equal): only the
    float32 summation order differs, the bias once added in the GEMM."""
    x, w, bias = _stem_inputs(*shape, seed=sum(shape))
    got = csp.conv_gemm_probe(x, w, bias)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 16)
    assert got.dtype == torch.bfloat16
    got, ref = got.float().numpy(), csp.conv_plain(x, w, bias).float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.03, rtol=0.02)
    assert (got == ref).mean() >= 0.999


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 → nearest bf16 (ties to even), as float32, in numpy."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_pool_plain_matches_its_definition(stem_numbers, port_inputs):
    """relu(maxpool3x3 s2 pad 1 (-inf)(bf16(((c0 + c1) + c2) + bias[co]))),
    c the canvas channels at (y+1, x+1), evaluated in numpy, bitwise."""
    canvas, _, *_ = stem_numbers
    bias = port_inputs[2].numpy()
    c = canvas[:, :, 1:-1, 1:-1, None]
    v = _bf16_round(((c[:, 0] + c[:, 1]) + c[:, 2]) + bias)  # (B, H, W, 16)
    pad = np.full((B, S + 2, S + 2, 16), -np.inf, np.float32)
    pad[:, 1:-1, 1:-1] = v
    ref = np.full((B, S // 2, S // 2, 16), -np.inf, np.float32)
    for dy in range(3):
        for dx in range(3):
            ref = np.maximum(ref, pad[:, dy:dy + S:2, dx:dx + S:2])
    ref = np.maximum(ref, 0)
    np.testing.assert_array_equal(csp.pool_plain(*port_inputs).float().numpy(), ref)


def _eval_layout():
    """Kernel A's stage and conv-tile layout as csrc/stem_core.cuh states
    it: the tile constants, EvalLayout's (CS, RS, PS, SH) and EVAL_SCS."""
    src = (Path(stem_core.__file__).resolve().parent.parent / "csrc" / "stem_core.cuh").read_text()
    c = {"TH": stem_core.TH, "TW": stem_core.TW}
    c["CR"], c["CC"] = 2 * c["TH"] + 1, 2 * c["TW"] + 1
    c["IR"], c["IC"] = c["CR"] + 2, c["CC"] + 2
    for name in ("ICB", "WORDS", "EVAL_SCS"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        c[name] = eval(expr.replace("/", "//"), {}, dict(c))  # C's int division
    args = re.search(r"typedef StageLayout<([^>]+)> EvalLayout;", src).group(1)
    c["CS"], c["RS"], c["PS"], c["SH"] = (eval(a, {}, dict(c)) for a in args.split(","))
    return c


def _pool_kernel_mirror(canvas, bias, n_cta):
    """csrc/stem_probe.cu's 'pool' kernel in numpy, tile by tile over the
    persistent walk: stage_canvas (rows from the even column x0 − 1, pairs
    outside the canvas zero), the centre-tap step in EvalLayout offsets
    (base(p) + tap(ci·9 + 4), so the +1 staging shift), bf16(((c0 + c1) +
    c2) + bias) in float32 or −inf outside the image at EVAL_SCS elements a
    position, then A's pool_max_relu item by item."""
    L = _eval_layout()
    b, _, h2, w2 = canvas.shape
    h, w = h2 - 2, w2 - 2
    hp, wp = h // 2, w // 2
    tx, ty, n_tiles = stem_core.tile_grid(b, h, w)
    tap = [(k // 9) * L["CS"] + ((k % 9) // 3) * L["RS"] + (k % 3) * L["PS"] for k in range(27)]
    p = np.arange(L["CR"] * L["CC"])
    r, c = p // L["CC"], p % L["CC"]
    base = r * L["RS"] + c * L["PS"] + L["SH"]
    out = np.full((b, hp, wp, 16), np.nan, np.float32)
    for cta in range(n_cta):
        for t in stem_core.cta_tiles(cta, n_cta, n_tiles):
            img, pr0, pc0 = stem_core.tile_origin(t, tx, ty)
            y0, x0 = 2 * pr0 - 1, 2 * pc0 - 1
            stage = np.zeros(3 * L["IR"] * L["ICB"], np.float32)
            for row in range(3 * L["IR"]):
                ci, gy = row // L["IR"], y0 + row % L["IR"]
                for word in range(L["WORDS"]):
                    gx = x0 - 1 + 2 * word
                    if 0 <= gy < h2 and 0 <= gx < w2:
                        stage[row * L["ICB"] + 2 * word:][:2] = canvas[img, ci, gy, gx:gx + 2]
            v = (stage[base + tap[4]] + stage[base + tap[13]]) + stage[base + tap[22]]
            conv = _bf16_round(v[:, None] + bias[None, :])
            y, x = y0 + r, x0 + c
            conv[~((y >= 0) & (y < h) & (x >= 0) & (x < w))] = -np.inf
            tile = np.zeros((len(p), L["EVAL_SCS"]), np.float32)
            tile[:, :16] = conv
            flat = tile.reshape(-1)
            for item in range(2 * stem_core.TH * stem_core.TW):
                lr, lc = divmod(item >> 1, stem_core.TW)
                half, pr, pc = item & 1, pr0 + lr, pc0 + lc
                if pr >= hp or pc >= wp:
                    continue
                m = np.zeros(8, np.float32)  # the ReLU, folded into the max
                for dy in range(3):
                    for dx in range(3):
                        at = ((2 * lr + dy) * L["CC"] + 2 * lc + dx) * L["EVAL_SCS"] + 8 * half
                        m = np.maximum(m, flat[at:at + 8])
                out[img, pr, pc, 8 * half:8 * half + 8] = m
    return out


@pytest.mark.parametrize("shape", [(3, 30, 18), (2, 64, 130), (1, 66, 66)])
def test_pool_kernel_mirror_matches_pool_plain(shape):
    """The 'pool' kernel's arithmetic and layout, mirrored in numpy over the
    persistent walk (a grid of 7, which divides nothing), reproduce
    `pool_plain` bitwise at shapes whose tiles do not divide the image.  The
    canvas border holds noise, which `pool_plain` never reads: so the conv
    positions outside the image must hold the padding, not a sum."""
    x, w, bias = _stem_inputs(*shape, seed=sum(shape) + 1)
    canvas = x.float().numpy()
    border = np.ones(canvas.shape[2:], bool)
    border[1:-1, 1:-1] = False
    canvas[:, :, border] = np.random.default_rng(1).integers(
        0, 256, canvas[:, :, border].shape)
    x = torch.from_numpy(canvas).to(torch.bfloat16)
    got = _pool_kernel_mirror(canvas, bias.numpy(), stem_core.num_ctas(*shape, 7))
    np.testing.assert_array_equal(got, csp.pool_plain(x, w, bias).float().numpy())
    assert got.max() > 100  # a live stand-in: three channels of 0..255 pixels


@pytest.mark.parametrize("variant", csp.VARIANTS)
def test_wrappers_take_plain_versions_on_cpu(port_inputs, variant):
    before = _build.launches()
    out = csp.stem_probe(variant, *port_inputs)
    assert out.shape == (B, S // 2, S // 2, 16) and out.dtype == torch.bfloat16
    assert torch.equal(out, csp.PLAIN[variant](*port_inputs))
    assert not _build.launches(before)
    with pytest.raises(ValueError):
        csp.stem_probe(variant, port_inputs[0][:, :, 1:], *port_inputs[1:])


@pytest.mark.parametrize("variant", csp.VARIANTS)
def test_variant_bound_counts_what_the_variant_moves(variant):
    """At b16 640²: every variant reads the whole canvas and the bias and
    writes the pooled shape once; all but pool read the weights too.  The
    bytes bound every variant on the H100."""
    canvas = torch.empty(16, 3, 642, 642, dtype=torch.bfloat16)
    w, bias = torch.empty(16, 3, 3, 3, dtype=torch.bfloat16), torch.empty(16)
    nbytes = 16 * 3 * 642 * 642 * 2 + 16 * 320 * 320 * 16 * 2 + 16 * 4
    if variant != "pool":
        nbytes += 16 * 27 * 2
    ms, by = probe.variant_bound(variant, canvas, w, bias)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_probe_entry_point_on_cpu(capsys):
    assert probe.main(["2", "--size", "32", "--iters", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert [ln.split(":")[0].strip() for ln in lines[1:6]] == list(csp.VARIANTS)
    assert all("bit-identical to full: True" in ln for ln in lines[4:6])
    assert lines[-1].startswith("split: (conv + pool) / full = ")
    with pytest.raises(ValueError):
        csp.stem_probe("dots", *probe.make_inputs(1, 32, "cpu"))


class _Loaded(Exception):
    """Raised by a stand-in for the library load: the call got past the
    sm_90 gate."""


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the gate."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("variant", ["conv", "pool", "dblbuf", "pipe"])
@pytest.mark.parametrize("cap", [(9, 0), (8, 0)])
def test_stem_probe_needs_sm90(monkeypatch, port_inputs, variant, cap):
    """On a CUDA device of another capability than (9, 0) a probe kernel
    request raises, naming sm_90, before the library loads; on sm_90 it goes
    on to the library."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)
    monkeypatch.setattr(csp, "_READY", set())
    loads = []

    def load():
        loads.append(1)
        raise _Loaded

    monkeypatch.setattr(csp._build, "load_library", load)
    on_card = [t.as_subclass(_OnCard) for t in port_inputs]
    before = _build.launches()
    if cap == (9, 0):
        with pytest.raises(_Loaded):
            csp.stem_probe(variant, *on_card)
        assert loads == [1] and csp._READY == {0}
    else:
        with pytest.raises(ValueError, match="sm_90"):
            csp.stem_probe(variant, *on_card)
        assert loads == [] and csp._READY == set()
    assert not _build.launches(before)


@pytest.mark.parametrize("cap", [(9, 0), (8, 0)])
def test_probe_entry_point_needs_sm90(monkeypatch, cap):
    """`run` on a CUDA device that is not sm_90 raises, naming sm_90, before
    it makes any input; on sm_90 it goes on to make them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)

    def make_inputs(*args, **kwargs):
        raise _Loaded

    monkeypatch.setattr(probe, "make_inputs", make_inputs)
    if cap == (9, 0):
        with pytest.raises(_Loaded):
            probe.run(1, 32, "cuda", iters=1)
    else:
        with pytest.raises(ValueError, match="sm_90"):
            probe.run(1, 32, "cuda", iters=1)
