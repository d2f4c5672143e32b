"""The host side of the stem kernels' shared core (dcfa_yolo_tpu_torch/ops/
stem_core.py, the counterpart of csrc/stem_core.cuh), on the CPU.

(a) The GEMM form of the conv that kernels A and C compute on the tensor
cores: im2col by `F.unfold`, K = 32 (27 taps in the order ci·9 + dy·3 + dx,
row 27 the bias against a ones column in A and zero in C, rows 28-31 zero),
one float32 matmul, rounding before the pools.  `stem_eval_gemm` and
`stem_train_gemm` are held against the plain versions and against the JAX
package (`pallas_stem_e` and `fused_train_stem` in Pallas interpret mode), in
the v4 class (tests/test_pallas_stem.py) and at the float32 tolerances of
tests/test_train_stem.py: only the float32 summation order differs.  The
stem split probe's 'conv' kernel runs A's GEMM and keeps, unpooled, the
value at each window's centre: relu(`conv_gemm_probe`) <= `stem_eval_gemm`
holds exactly.

(b) The persistent tile schedule the wrappers hand the kernels: every pooled
pixel is written by exactly one tile, and every conv pixel is counted
exactly once in kernel C's sums; the probe's 'conv' finish writes each
pooled pixel once, with its centre conv value and never the -inf padding;
the probe's 'pipe' kernel, whose conv and pool warps walk the CTA's tiles
as two roles ordered by named barriers, neither deadlocks nor overwrites a
conv slot the pool role still reads, and pools every tile once.
"""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfa_yolo_tpu.ops.pallas_stem import fold_stem_params_e, pallas_stem_e
from dcfa_yolo_tpu.ops.pallas_stem_train import fused_train_stem as jax_fused
from dcfa_yolo_tpu.ops.resize import deinterleave_cols_cf
from dcfa_yolo_tpu_torch.ops import cuda_stem, cuda_stem_probe, cuda_stem_train, stem_core

torch.set_num_threads(1)

EPS = 1e-5
SHAPES = [(2, 32, 48), (1, 30, 18), (1, 66, 66)]


def _eval_inputs(seed, shape):
    """A raw 0..255 canvas with its zero border and folded weights."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 16)) * 0.3).astype(np.float32)  # HWIO
    bn = [(rng.standard_normal(16) * s + m).astype(np.float32)
          for s, m in ((0.2, 1.0), (0.2, 0.0), (0.1, 0.0))]
    var = (rng.random(16) + 0.5).astype(np.float32)
    params = (k, *bn, var)
    canvas = np.pad(img.transpose(0, 3, 1, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
    w, bias = cuda_stem.fold_stem_params(torch.from_numpy(k).permute(3, 2, 0, 1),
                                         *(torch.from_numpy(p) for p in params[1:]))
    return canvas, params, w, bias


def _v4_class(port, ref):
    np.testing.assert_allclose(port, ref, atol=0.03, rtol=0.02)
    frac = (port == ref).mean()
    assert frac >= 0.999, f"only {frac} bit-equal"


def _train_inputs(seed, shape):
    b, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)  # HWIO
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.1).astype(np.float32)
    return x, k, gamma, beta


# ---- (a) the GEMM packing ---------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
def test_pack_k32_rows(with_bias):
    """Rows 0-26 hold weight[co, ci, dy, dx] at k = ci·9 + dy·3 + dx, row 27
    the bias (A) or zero (C), rows 28-31 zero."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 3, 3, 3)).astype(np.float32))
    bias = torch.arange(16, dtype=torch.float32) + 1 if with_bias else None
    b = stem_core.pack_k32(w, bias)
    assert b.shape == (32, 16) and b.dtype == torch.float32
    for ci in range(3):
        for dy in range(3):
            for dx in range(3):
                assert torch.equal(b[ci * 9 + dy * 3 + dx], w[:, ci, dy, dx])
    assert torch.equal(b[27], bias if with_bias else torch.zeros(16))
    assert not b[28:].any()


@pytest.mark.parametrize("ones,padding", [(True, 0), (False, 1)])
def test_im2col_k32_columns(ones, padding):
    """Column k = ci·9 + dy·3 + dx of position (y, x) is input (ci, y + dy,
    x + dx) of the (padded) input; column 27 is 1 (A) or 0 (C); 28-31 are
    0: finite values in every padding column."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3, 7, 9)).astype(np.float32))
    cols = stem_core.im2col_k32(x, ones, padding)
    xp = torch.nn.functional.pad(x, (padding,) * 4)
    h, w = xp.shape[2] - 2, xp.shape[3] - 2
    assert cols.shape == (2, h * w, 32)
    for y, xx in ((0, 0), (h - 1, w - 1), (2, 3)):
        row = cols[:, y * w + xx]
        for ci in range(3):
            for dy in range(3):
                for dx in range(3):
                    assert torch.equal(row[:, ci * 9 + dy * 3 + dx], xp[:, ci, y + dy, xx + dx])
    assert torch.equal(cols[..., 27], torch.full_like(cols[..., 27], float(ones)))
    assert not cols[..., 28:].any()


def test_pack_matches_the_cuda_core_geometry():
    """The Python schedule and packing use the tile and K constants of
    csrc/stem_core.cuh."""
    src = (Path(stem_core.__file__).resolve().parent.parent / "csrc" / "stem_core.cuh").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["TH"]) == stem_core.TH and int(const["TW"]) == stem_core.TW
    assert "K = 32" in src and "row 27" in src and stem_core.K == 32


@pytest.mark.parametrize("shape", SHAPES)
def test_eval_gemm_matches_plain(shape):
    canvas, _, w, bias = _eval_inputs(3, shape)
    x = torch.from_numpy(canvas).to(torch.bfloat16)
    got = cuda_stem.stem_eval_gemm(x, w, bias)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 16)
    assert got.dtype == torch.bfloat16
    _v4_class(got.float().numpy(), cuda_stem.stem_eval_plain(x, w, bias).float().numpy())


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 130)])  # v4 needs H % 16 == 0
def test_eval_gemm_matches_pallas_e(shape):
    canvas, params, w, bias = _eval_inputs(4, shape)
    we = fold_stem_params_e(*(jnp.asarray(p) for p in params))
    ref = pallas_stem_e(deinterleave_cols_cf(jnp.asarray(canvas)), we, w=shape[2],
                        interpret=True)
    ref = np.asarray(jnp.transpose(ref, (0, 1, 3, 2)), np.float32)  # NHWC
    got = cuda_stem.stem_eval_gemm(torch.from_numpy(canvas).to(torch.bfloat16), w, bias)
    _v4_class(got.float().numpy(), ref)


def test_eval_gemm_bias_row_is_the_bias():
    """With zero weights the GEMM gives relu(bf16(bias)) everywhere: the
    bias reaches every position through row 27 and the ones column."""
    canvas, _, w, bias = _eval_inputs(5, (1, 8, 8))
    got = cuda_stem.stem_eval_gemm(torch.from_numpy(canvas).to(torch.bfloat16),
                                   torch.zeros_like(w), bias)
    want = torch.relu(bias.to(torch.bfloat16)).float().expand(1, 4, 4, 16)
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_probe_gemm_under_eval_gemm(shape):
    """relu(conv) <= full, exactly, in the kernels' arithmetic: conv position
    (2i, 2j) is the centre of pooled pixel (i, j)'s window, and A pools the
    same bf16 values (the invariant chip_smoke.py holds on the card)."""
    canvas, _, w, bias = _eval_inputs(8, shape)
    x = torch.from_numpy(canvas).to(torch.bfloat16)
    conv = cuda_stem_probe.conv_gemm_probe(x, w, bias).float()
    full = cuda_stem.stem_eval_gemm(x, w, bias).float()
    assert conv.shape == full.shape
    assert bool((torch.relu(conv) <= full).all())
    assert conv.abs().max() > 0.5 and (torch.relu(conv) == full).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_train_gemm_matches_plain(shape, dtype):
    """bf16: pools in the v4 class, sums within 1e-3 relative; float32: pools
    within 1e-5 of max|ĉ| plus 1e-5 relative, sums within 1e-4 relative."""
    x, k, _, _ = _train_inputs(6, shape)
    xt = torch.from_numpy(x).to(dtype)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(dtype)
    got = cuda_stem_train.stem_train_gemm(xt, kt)
    ref = cuda_stem_train.stem_train_plain(xt, kt)
    assert all(g.dtype == r.dtype and g.shape == r.shape for g, r in zip(got, ref))
    c_max = max(ref[0].float().abs().max().item(), ref[1].float().abs().max().item())
    for g, r in zip(got[:2], ref[:2]):
        g, r = g.float().numpy(), r.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * c_max)
        else:
            _v4_class(g, r)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=tol,
                               atol=tol * ref[2].abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gemm_matches_jax_fused(monkeypatch, dtype):
    """`fused_train_stem` on the GEMM form (in place of the kernel) against
    the JAX `fused_train_stem` in interpret mode, at the tolerances of
    tests/test_torch_train_stem.py: float32 y, mean and var at atol 1e-5;
    bf16 y within one bf16 step, moments at rtol 1e-4."""
    x, k, gamma, beta = _train_inputs(7, (2, 32, 64))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y_j, m_j, v_j = jax_fused(jnp.asarray(x, jdt), jnp.asarray(k), jnp.asarray(gamma),
                              jnp.asarray(beta), EPS, None, True)
    y_j = np.asarray(y_j.astype(jnp.float32))
    calls = []
    monkeypatch.setattr(cuda_stem_train, "stem_train",
                        lambda x, w, group=None: calls.append(1)
                        or cuda_stem_train.stem_train_gemm(x, w))
    y, m, v = cuda_stem_train.fused_train_stem(
        torch.from_numpy(x).to(dtype), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(gamma), torch.from_numpy(beta), EPS)
    assert calls == [1] and y.dtype == dtype
    if dtype == torch.float32:
        for port, ref in ((y, y_j), (m, m_j), (v, v_j)):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)
    else:
        d = np.abs(y.float().numpy() - y_j)
        assert (d <= 2.0 ** -7 * np.maximum(np.abs(y_j), 1.0) + 1e-6).all()
        assert (d == 0).mean() >= 0.99
        np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-4, atol=1e-5)


# ---- (b) the persistent tile schedule ---------------------------------------

SCHED_HW = [(640, 640), (320, 320), (1280, 1280), (64, 130), (30, 18), (66, 66)]


def _walk(b, h, w, n_cta):
    """(cta, tile) in the order the kernels visit them."""
    n_tiles = stem_core.tile_grid(b, h, w)[2]
    for cta in range(n_cta):
        for t in stem_core.cta_tiles(cta, n_cta, n_tiles):
            yield cta, t


def _pooled_block(t, h, w, tx, ty):
    """(image, pooled rows, pooled cols) that tile t writes."""
    b, pr0, pc0 = stem_core.tile_origin(t, tx, ty)
    return b, range(pr0, min(pr0 + stem_core.TH, h // 2)), range(pc0, min(pc0 + stem_core.TW, w // 2))


def _owned_conv_block(t, h, w, tx, ty):
    """(image, conv rows, conv cols) whose values tile t adds to kernel C's
    sums: rows [2·pr0, 2·pr0 + 2·TH) and cols [2·pc0, 2·pc0 + 2·TW) inside
    the image (csrc/stem_core.cuh::owns)."""
    b, pr0, pc0 = stem_core.tile_origin(t, tx, ty)
    return (b, range(2 * pr0, min(2 * pr0 + 2 * stem_core.TH, h)),
            range(2 * pc0, min(2 * pc0 + 2 * stem_core.TW, w)))
RESIDENT = [264, 7]  # two CTAs on each of an H100's 132 SMs; a count that divides nothing


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("hw", SCHED_HW)
def test_schedule_writes_every_pooled_pixel_once(b, hw):
    h, w = hw
    tx, ty, n_tiles = stem_core.tile_grid(b, h, w)
    assert n_tiles == b * -(-(h // 2) // 8) * -(-(w // 2) // 16)
    for resident in RESIDENT:
        n_cta = stem_core.num_ctas(b, h, w, resident)
        assert n_cta == min(n_tiles, resident)
        written = np.zeros((b, h // 2, w // 2), np.int32)
        seen = np.zeros(n_tiles, np.int32)
        for _, t in _walk(b, h, w, n_cta):
            seen[t] += 1
            img, rows, cols = _pooled_block(t, h, w, tx, ty)
            assert len(rows) and len(cols)  # no tile lies wholly outside
            written[img, rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (seen == 1).all()
        assert (written == 1).all()


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("hw", SCHED_HW)
def test_schedule_counts_every_conv_pixel_once(b, hw):
    """Kernel C's ownership rule: a tile adds conv rows [2·pr0, 2·pr0 + 16)
    and cols [2·pc0, 2·pc0 + 32) inside the image to its CTA's sums."""
    h, w = hw
    tx, ty, _ = stem_core.tile_grid(b, h, w)
    for resident in RESIDENT:
        counted = np.zeros((b, h, w), np.int32)
        per_cta = {}
        for cta, t in _walk(b, h, w, stem_core.num_ctas(b, h, w, resident)):
            img, rows, cols = _owned_conv_block(t, h, w, tx, ty)
            counted[img, rows.start:rows.stop, cols.start:cols.stop] += 1
            per_cta[cta] = per_cta.get(cta, 0) + len(rows) * len(cols)
        assert (counted == 1).all()
        assert sum(per_cta.values()) == b * h * w


@pytest.mark.parametrize("shape", [(3, 30, 18), (2, 64, 130), (1, 66, 66)])
def test_conv_probe_finish_writes_every_pooled_pixel_once(shape):
    """The probe 'conv' kernel's finish over the persistent walk.  Each tile
    holds A's conv tile: conv rows 2·pr0 − 1 + r (r < 2·TH + 1), cols
    2·pc0 − 1 + c (c < 2·TW + 1), −inf outside the image.  Pooled pixel
    (pr0 + lr, pc0 + lc) inside the image reads tile position (2·lr + 1,
    2·lc + 1).  Every pooled pixel is written once, with conv (2i, 2j),
    never the padding."""
    b, h, w = shape
    cr, cc = 2 * stem_core.TH + 1, 2 * stem_core.TW + 1
    tx, ty, _ = stem_core.tile_grid(b, h, w)
    conv = np.random.default_rng(h * w).standard_normal((b, h, w)).astype(np.float32)
    # the conv tiles of the last tile row and col reach past the image
    padded = np.full((b, h + cr + 1, w + cc + 1), -np.inf, np.float32)
    padded[:, 1:h + 1, 1:w + 1] = conv
    for resident in RESIDENT:
        out = np.full((b, h // 2, w // 2), np.nan, np.float32)
        written = np.zeros((b, h // 2, w // 2), np.int32)
        for _, t in _walk(b, h, w, stem_core.num_ctas(b, h, w, resident)):
            img, pr0, pc0 = stem_core.tile_origin(t, tx, ty)
            y0, x0 = 2 * pr0 - 1, 2 * pc0 - 1
            tile = padded[img, y0 + 1:y0 + 1 + cr, x0 + 1:x0 + 1 + cc]
            assert tile.shape == (cr, cc)
            for lr in range(stem_core.TH):
                for lc in range(stem_core.TW):
                    pr, pc = pr0 + lr, pc0 + lc
                    if pr < h // 2 and pc < w // 2:
                        out[img, pr, pc] = tile[2 * lr + 1, 2 * lc + 1]
                        written[img, pr, pc] += 1
        assert (written == 1).all()
        np.testing.assert_array_equal(out, conv[:, ::2, ::2])


class _TileIndex:
    """csrc/stem_core.cuh::TileIndex: tile t as (image, tile row, tile col),
    advanced by a step of tiles with one carry each, no division."""

    def __init__(self, t, tx, ty):
        self.b, rem = divmod(t, tx * ty)
        self.ty, self.tx = divmod(rem, tx)

    def advance(self, step, tx, ty):
        self.tx += step.tx
        self.ty += step.ty + (self.tx >= tx)
        if self.tx >= tx:
            self.tx -= tx
        self.b += step.b + (self.ty >= ty)
        if self.ty >= ty:
            self.ty -= ty

    def copy(self):
        c = _TileIndex.__new__(_TileIndex)
        c.b, c.ty, c.tx = self.b, self.ty, self.tx
        return c

    def tile(self):
        return self.b, self.ty * stem_core.TH, self.tx * stem_core.TW


BAR_FULL, BAR_EMPTY = 2, 4  # + slot, as in csrc/stem_probe.cu


def _pipe_roles(cta, n_cta, b, h, w):
    """csrc/stem_probe.cu::pipe_walk for CTA `cta`: its tile count n and its
    two roles as generators of (op, ...) events, step for step as the
    kernel's loops.  The conv role's own barrier (BAR_CONV, conv threads
    only) orders its steps in program order, so it is not an event."""
    tx, ty, n_tiles = stem_core.tile_grid(b, h, w)
    n = (n_tiles - 1 - cta) // n_cta + 1
    step = _TileIndex(n_cta, tx, ty)

    def conv():
        cur = _TileIndex(cta, tx, ty)
        yield "stage", 0, cur.tile()
        for k in range(n):
            slot = k & 1
            nxt = cur.copy()
            nxt.advance(step, tx, ty)
            if k + 1 < n:
                yield "stage", slot ^ 1, nxt.tile()
            if k >= 2:
                yield "sync", BAR_EMPTY + slot
            yield "write", slot, cur.tile()
            yield "arrive", BAR_FULL + slot
            cur = nxt

    def pool():
        cur = _TileIndex(cta, tx, ty)
        for k in range(n):
            slot = k & 1
            yield "sync", BAR_FULL + slot
            yield "read", slot, cur.tile()
            if k + 2 < n:
                yield "arrive", BAR_EMPTY + slot
            cur.advance(step, tx, ty)

    return n, {"conv": conv(), "pool": pool()}


def _run_pipe_cta(roles, rnd):
    """Interleave the two roles at random, as the warps may run, and hold
    each event to the kernel's hazards.  Named barrier `bar` completes a
    phase when both roles have reached it (one arrives, the other syncs); a
    sync waits for that, and a role that reached a barrier again before its
    last phase there completed would land in that phase (a lost sync).
    Returns the tiles the pool role pooled, in order, and the per-barrier
    counts of each role."""
    other = {"conv": "pool", "pool": "conv"}
    seen = {r: {} for r in roles}          # bar -> times reached
    stage, slots, pooled = {}, {0: None, 1: None}, []
    pending = {r: next(g, None) for r, g in roles.items()}

    def blocked(r):
        op = pending[r]
        return (op is not None and op[0] == "sync"
                and seen[other[r]].get(op[1], 0) < seen[r].get(op[1], 0) + 1)

    while any(op is not None for op in pending.values()):
        ready = [r for r in roles if pending[r] is not None and not blocked(r)]
        assert ready, f"deadlock at {pending}"
        r = ready[0] if len(ready) == 1 else ready[rnd.random() < 0.5]
        op = pending[r]
        if op[0] in ("sync", "arrive"):
            mine, theirs = seen[r].get(op[1], 0), seen[other[r]].get(op[1], 0)
            assert mine <= theirs, f"{r} reached barrier {op[1]} twice in one phase"
            seen[r][op[1]] = mine + 1
            if r == "pool" and op[0] == "arrive":  # BAR_EMPTY + slot: released
                s = op[1] - BAR_EMPTY
                assert slots[s][0] == "read"
                slots[s] = ("free",)
        elif op[0] == "stage":
            stage[op[1]] = op[2]
        elif op[0] == "write":
            _, s, tile = op
            assert stage[s] == tile, "conv step read another tile's input"
            assert slots[s] is None or slots[s][0] == "free", (
                f"slot {s} refilled with {tile} before the pool role released it")
            slots[s] = ("full", tile)
        else:  # read
            _, s, tile = op
            assert slots[s] == ("full", tile), f"pooled {tile} from slot {s} holding {slots[s]}"
            slots[s] = ("read", tile)
            pooled.append(tile)
        pending[r] = next(roles[r], None)
    return pooled, seen


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("hw", SCHED_HW)
def test_pipe_walk_model(b, hw):
    """The probe 'pipe' kernel's split-role walk on the persistent grid:
    each role takes the CTA's tiles in cta_tiles order; slot s is refilled
    with tile k+2 only after the pool role released tile k; no deadlock,
    whatever the interleaving, at any tile count, ragged or not; every
    arrive has its sync; every pooled pixel is written once."""
    h, w = hw
    tx, ty, n_tiles = stem_core.tile_grid(b, h, w)
    rnd = random.Random(b * h + w)
    for resident in RESIDENT:
        n_cta = stem_core.num_ctas(b, h, w, resident)
        written = np.zeros((b, h // 2, w // 2), np.int32)
        for cta in range(n_cta):
            n, roles = _pipe_roles(cta, n_cta, b, h, w)
            want = [stem_core.tile_origin(t, tx, ty)
                    for t in stem_core.cta_tiles(cta, n_cta, n_tiles)]
            assert n == len(want) >= 1
            pooled, seen = _run_pipe_cta(roles, rnd)
            assert pooled == want
            assert seen["conv"] == seen["pool"]  # every arrive has its sync
            for img, pr0, pc0 in pooled:
                written[img, pr0:min(pr0 + stem_core.TH, h // 2),
                        pc0:min(pc0 + stem_core.TW, w // 2)] += 1
        assert (written == 1).all()


def test_schedule_tile_order_and_grid():
    """Tile t = (image · tiles_y + tile row) · tiles_x + tile col; CTA i
    walks i, i + grid, ...; the grid never exceeds the tiles."""
    tx, ty, n = stem_core.tile_grid(2, 30, 18)
    assert (tx, ty, n) == (1, 2, 4)
    assert [stem_core.tile_origin(t, tx, ty) for t in range(n)] == [
        (0, 0, 0), (0, 8, 0), (1, 0, 0), (1, 8, 0)]
    assert list(stem_core.cta_tiles(1, 3, 10)) == [1, 4, 7]
    assert stem_core.num_ctas(16, 640, 640, 264) == 264
    assert stem_core.num_ctas(1, 30, 18, 264) == 2
    with pytest.raises(ValueError):
        stem_core.num_ctas(1, 64, 64, 0)
