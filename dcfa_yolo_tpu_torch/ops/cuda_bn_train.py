"""Train-mode BatchNorm (kernel D): batch moments, normalise, affine and
cast, and their backward, in hand-written CUDA (`csrc/bn_train.cu`).

Replaces no TPU kernel: the JAX package writes the train BN as plain jnp
(`dcfa_yolo_tpu/ops/norm.py`, `TorchExactBatchNorm`) and XLA fuses it on the
TPU.  The same formula in eager PyTorch is some 25 float32 kernels a layer
and keeps three float32 copies of every input for its backward; D runs it
in three launches forward (four across the ranks of a group) and three
backward, and saves only x and its per-channel statistics.  It is bounded
by bytes (`csrc/bn_train.cu`: x read twice and y written once forward, x and
the cotangent read twice and dx written once backward).

The semantics are `ops/norm.py`'s (`BatchNorm.train_plain`, the plain
version, which the train branch runs on the CPU): the moments `mean` and
`mean²` in float32 over N, H and W, averaged over `group`'s ranks (SyncBN),
`var = max(mean² − mean², 0)`, normalise in float32 and one rounding to the
output dtype; the gradient is the formula's as written, through the batch
mean and `mean²`, with the clamp's mask; torch's running update with the
Bessel factor n/(n−1), skipped while a checkpointed forward is recomputed
(`update`).

`bn_train` takes a CUDA tensor and launches D, or raises (three dtype
routes, NCHW-contiguous or channels_last, at most `MAX_CHANNELS` channels):
nothing falls back.  `_build.launches()["bn_train"]` counts D's launches.

D sums in a fixed order (per-thread float over at most 8 loads, then double;
the blocks' partials added in double in a fixed order), uses no atomics and
allocates nothing itself, so a replay and a `--remat` recompute are
bit-equal to the first run.  Its sums are more exact than the plain
version's float32 reductions, so the two agree to rounding, not bit for bit;
`mean` and `mean²` are rounded to float32 as the plain version's are (and
as the ranks of a group exchange them, so that a group of one gives what no
group gives), and the variance and rstd follow in double.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcfa_yolo_tpu_torch.ops import _build
from dcfa_yolo_tpu_torch.parallel.mesh import all_reduce_mean, world_size

THREADS = 256
BLOCKS_PER_SM = 8    # blocks a grid aims at for each SM of the card
MAX_CHANNELS = 3072  # the elementwise passes keep 4 floats a channel in 48 KB
# (input dtype, output dtype) pairs D takes, and its dtype codes
ROUTES = {(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.float32)}
_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS: dict = {}


class Plan(NamedTuple):
    """How D walks an input: its layout, sizes and vector width, the sums'
    grid (NCHW: (chunks, C), `chunk` vectors a block; NHWC: (chunks,
    ceil(C / vec / txn)), `chunk` rows a block, `txn` column vectors a
    block) and the elementwise passes' grid."""

    nhwc: bool
    n: int
    c: int
    hw: int
    vec: int     # elements a load: 16 bytes of x's type, or 1
    chunks: int
    chunk: int
    txn: int
    nvec: int    # N·C·H·W / vec
    grid: int


def layout_of(x: torch.Tensor) -> bool:
    """True for channels_last (NHWC in memory), False for NCHW-contiguous;
    raises on any other layout of a 4-d tensor."""
    if x.dim() != 4:
        raise ValueError(f"the train BN takes (N, C, H, W), got {tuple(x.shape)}")
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError("the train BN kernel takes NCHW-contiguous or channels_last "
                     f"inputs, got shape {tuple(x.shape)} with strides {x.stride()}")


def plan(shape, nhwc: bool, elem_bytes: int, aligned: bool, sms: int) -> Plan:
    """D's plan for an input of `shape` (N, C, H, W): 16-byte vectors where
    they divide the contiguous axis (C in NHWC, H·W in NCHW) and the
    pointers are `aligned`, else one element a load; every grid aims at
    `BLOCKS_PER_SM` blocks on each of `sms` SMs, and at no fewer than one
    vector (NCHW) or row (NHWC) a thread."""
    n, c, h, w = shape
    hw = h * w
    vmax = 16 // elem_bytes
    vec = vmax if aligned and (c if nhwc else hw) % vmax == 0 else 1
    target = BLOCKS_PER_SM * sms
    nvec = n * c * hw // vec
    if nhwc:
        ncv = c // vec
        txn = min(ncv, 32)
        groups = -(-ncv // txn)
        rows = n * hw
        chunks = max(1, min(-(-target // groups), -(-rows // (THREADS // txn))))
        chunk = -(-rows // chunks)
        chunks = -(-rows // chunk)
    else:
        txn = 0
        nv = n * hw // vec
        chunks = max(1, min(-(-target // c), -(-nv // THREADS)))
        chunk = -(-nv // chunks)
        chunks = -(-nv // chunk)
    grid = max(1, min(-(-nvec // THREADS), target))
    return Plan(nhwc, n, c, hw, vec, chunks, chunk, txn, nvec, grid)


def check_route(x: torch.Tensor, dtype: torch.dtype, params) -> bool:
    """The checks a CUDA call must pass before D launches: a dtype route of
    `ROUTES`, a layout `layout_of` takes, 1 to `MAX_CHANNELS` channels, a
    non-empty input of fewer than 2³¹ elements, and float32 contiguous
    (C,) parameters and running statistics on x's device.  Returns the
    layout (True for channels_last); raises on anything else."""
    nhwc = layout_of(x)
    if (x.dtype, dtype) not in ROUTES:
        raise ValueError(f"the train BN kernel takes float32 → bf16, bf16 → bf16 or "
                         f"float32 → float32, got {x.dtype} → {dtype}")
    c = x.shape[1]
    if not 0 < c <= MAX_CHANNELS or x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"the train BN kernel takes 1 to {MAX_CHANNELS} channels and "
                         f"1 to 2³¹ − 1 elements, got shape {tuple(x.shape)}")
    for t in params:
        if (t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
                or tuple(t.shape) != (c,)):
            raise ValueError(f"the train BN's parameters and statistics must be contiguous "
                             f"float32 ({c},) tensors on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return nhwc


def _sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(rc: int, what: str) -> None:
    _build.check(rc, what, "bn_train")


def _moments(x, p: Plan, eps, running, update, momentum, group):
    """Launches 1-2 of the forward: (3, C) float32 [mean, rstd, mask], the
    running statistics moved where `update`."""
    lib = _build.load_library()
    st = torch.cuda.current_stream(x.device).cuda_stream
    part = torch.empty((p.chunks, p.c, 2), dtype=torch.float64, device=x.device)
    stats = torch.empty((3, p.c), dtype=torch.float32, device=x.device)
    xt = _CODE[x.dtype]
    _check(lib.bn_train_sums(0, xt, xt, int(p.vec > 1), int(p.nhwc), x.data_ptr(), None, None,
                             part.data_ptr(), p.n, p.c, p.hw, p.chunks, p.chunk, p.txn, st),
           "bn_train moments")
    n_local = p.n * p.hw
    n_all = n_local * world_size(group)
    om, m = 1.0 - momentum, momentum
    bessel = n_all / max(n_all - 1.0, 1.0)
    rm, rv = (running[0].data_ptr(), running[1].data_ptr()) if update else (None, None)
    reduced = None
    if group is not None:
        gathered = torch.empty((2, p.c), dtype=torch.float32, device=x.device)
        _check(lib.bn_train_finalize(part.data_ptr(), p.chunks, p.c, float(n_local), eps, None,
                                     gathered.data_ptr(), None, None, None, om, m, bessel, st),
               "bn_train finalize")
        reduced = all_reduce_mean(gathered, group)
    _check(lib.bn_train_finalize(part.data_ptr(), p.chunks, p.c, float(n_local), eps,
                                 None if reduced is None else reduced.data_ptr(), None,
                                 stats.data_ptr(), rm, rv, om, m, bessel, st),
           "bn_train finalize")
    return stats


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, dtype, group,
                update, p):
        stats = _moments(x, p, eps, (running_mean, running_var), update, momentum, group)
        y = torch.empty_like(x, dtype=dtype)
        xt, yt = _CODE[x.dtype], _CODE[dtype]
        _check(_build.load_library().bn_train_elementwise(
            0, xt, yt, int(p.vec > 1), int(p.nhwc), x.data_ptr(), None, y.data_ptr(),
            stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), 0.0, p.n, p.c, p.hw, p.grid,
            torch.cuda.current_stream(x.device).cuda_stream), "bn_train normalise")
        ctx.save_for_backward(x, stats, weight)
        ctx.group, ctx.plan = group, p
        return y

    @staticmethod
    def backward(ctx, gy):
        x, stats, weight = ctx.saved_tensors
        p: Plan = ctx.plan
        fmt = torch.channels_last if p.nhwc else torch.contiguous_format
        if not gy.is_contiguous(memory_format=fmt) or (p.vec > 1 and not _aligned(gy)):
            gy = gy.clone(memory_format=fmt)
        lib = _build.load_library()
        st = torch.cuda.current_stream(x.device).cuda_stream
        xt, gt = _CODE[x.dtype], _CODE[gy.dtype]
        part = torch.empty((p.chunks, p.c, 2), dtype=torch.float64, device=x.device)
        _check(lib.bn_train_sums(1, xt, gt, int(p.vec > 1), int(p.nhwc), x.data_ptr(),
                                 gy.data_ptr(), stats.data_ptr(), part.data_ptr(), p.n, p.c,
                                 p.hw, p.chunks, p.chunk, p.txn, st), "bn_train grad sums")
        out = torch.empty((4, p.c), dtype=torch.float32, device=x.device)
        _check(lib.bn_train_grad_finalize(part.data_ptr(), p.chunks, p.c, stats.data_ptr(),
                                          weight.data_ptr(), out.data_ptr(), st),
               "bn_train grad finalize")
        dx = None
        if ctx.needs_input_grad[0]:
            dm = out[:2] if ctx.group is None else all_reduce_mean(out[:2], ctx.group)
            dx = torch.empty_like(x)
            _check(lib.bn_train_elementwise(
                1, xt, gt, int(p.vec > 1), int(p.nhwc), x.data_ptr(), gy.data_ptr(),
                dx.data_ptr(), stats.data_ptr(), weight.data_ptr(), dm.data_ptr(),
                1.0 / (p.n * p.hw), p.n, p.c, p.hw, p.grid, st), "bn_train apply")
        return (dx, out[2] if ctx.needs_input_grad[1] else None,
                out[3] if ctx.needs_input_grad[2] else None) + (None,) * 8


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
             eps: float, dtype: Optional[torch.dtype] = None, group=None,
             update: bool = True) -> torch.Tensor:
    """Train-mode BN of the NCHW CUDA tensor x (module docstring) in
    `dtype` (default x's), differentiable in x, weight and bias; the
    running statistics move in place where `update`.  Launches D, and
    raises on another device or where `check_route` refuses x."""
    dtype = dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"kernel D runs on a CUDA device, got {x.device}")
    nhwc = check_route(x, dtype, (weight, bias, running_mean, running_var))
    p = plan(tuple(x.shape), nhwc, x.element_size(), _aligned(x), _sms(x.device))
    return _BnTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps, dtype,
                          group, update, p)
