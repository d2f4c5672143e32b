"""Fused train-mode stem: conv3x3 s1 (3→16) + train-BatchNorm + ReLU +
maxpool3x3 s2, with the full-resolution pass in one hand-written CUDA kernel
(`csrc/stem_train.cu`, kernel C, on the shared core `csrc/stem_core.cuh`:
the bf16 conv on the tensor cores, a persistent double-buffered tile walk).

Port of `dcfa_yolo_tpu/ops/pallas_stem_train.py` (`fused_train_stem`), in
both of its compute dtypes (one CUDA template, C entries `stem_train_bf16`
and `stem_train_f32`).  The kernel reads the NHWC input once and emits max
pool, min pool and the per-channel Σĉ, Σĉ² of the conv output ĉ in the
compute dtype (rounded to bf16 in bf16, unrounded in float32).  The
BN affine a·ĉ + b commutes with the pools up to the sign of a, so BN and
ReLU run at pool resolution on the max or the min pool by sign(γ)
(`_fused_fwd_impl`, `pallas_stem_train.py:296-325`).

`stem_train` launches the kernel for a CUDA tensor and uses the plain
version `stem_train_plain` only for a CPU tensor; `LAUNCHES` counts kernel
launches of both dtypes, `LAUNCHES_F32` those in float32.
`stem_train_gemm` computes the kernel's arithmetic in plain PyTorch, in the
kernel's GEMM form (`ops/stem_core.py`).
`fused_train_stem` is the differentiable function; its backward
differentiates the plain decomposition `reference_stem`, as the JAX VJP does
(`pallas_stem_train.py:328-337`): the TPU kernel has no backward kernel.

Across the ranks of a process group (data-parallel fused training, the
JAX `_partitionable_stem_train` and `_stats_to_moments`,
`pallas_stem_train.py:193-254`) each rank runs the kernel on its local
batch and the float64 totals of the sums are all-reduced, then rounded
once to float32: the moments depend on the number of ranks only through
that rounding.  The backward's reference averages its batch mean and mean²
over the group (the pmean of `:269-271`).  Every rank must take the same
path and make the same collective calls: an empty or unequal local batch
raises on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dcfa_yolo_tpu_torch.device import kernels_supported
from dcfa_yolo_tpu_torch.ops import _build, stem_core
from dcfa_yolo_tpu_torch.ops.norm import batch_moments
from dcfa_yolo_tpu_torch.parallel.mesh import world_size

STEM_CO = 16  # the kernel is specialised to phi='n''s 16 stem channels
LAUNCHES = 0      # kernel launches, both dtypes
LAUNCHES_F32 = 0  # of which float32
_ENTRIES = {torch.bfloat16: "stem_train_bf16", torch.float32: "stem_train_f32"}
# the float32 kernel reads its weights from one constant-memory buffer per
# device, written on the launch's stream: a launch on another stream than
# the last one first waits for that stream, so no launch reads another's
# weights
_F32_LAST_STREAM: dict = {}


def order_f32(stream: torch.cuda.Stream) -> None:
    """Before a float32 launch (or a graph that holds one) on `stream`: wait
    for the stream of the last one on its device, and become it."""
    last = _F32_LAST_STREAM.get(stream.device.index)
    if last is not None and last != stream:
        stream.wait_stream(last)
    _F32_LAST_STREAM[stream.device.index] = stream


def resolve_train_stem(backend: str, c_out: int, hw: Tuple[int, int],
                       dtype: torch.dtype, device: torch.device) -> str:
    """'kernel' or 'plain' for the train-mode stem.

    'auto' picks the kernel on a CUDA sm_90 device wherever it applies: 16
    stem channels, even H and W, and bf16 or float32 compute (the kernel's
    two instantiations).  An explicit 'kernel' that cannot be met raises; on
    a CPU tensor the kernel's wrapper takes its plain version.
    """
    shape_ok = c_out == STEM_CO and hw[0] % 2 == 0 and hw[1] % 2 == 0
    on_card = kernels_supported(device)
    dtype_ok = dtype in _ENTRIES
    if backend == "auto":
        return "kernel" if shape_ok and on_card and dtype_ok else "plain"
    if backend == "plain":
        return "plain"
    if backend != "kernel":
        raise ValueError(f"unknown train stem backend {backend!r}")
    if not shape_ok:
        raise ValueError(f"the train stem kernel needs {STEM_CO} channels and "
                         f"an even input shape, got {c_out} and {tuple(hw)}")
    if not dtype_ok or (device.type == "cuda" and not on_card):
        raise ValueError("the train stem kernel needs an sm_90 card and bf16 "
                         f"or float32 compute, got {device} and {dtype}")
    return "kernel"


def stem_train_plain(x: torch.Tensor, weight: torch.Tensor, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel.  x (B, H, W, 3) NHWC, weight
    (16, 3, 3, 3) in x's dtype → (pmax, pmin (B, H/2, W/2, 16) in x's dtype,
    sums (16, 2) float32 [Σĉ, Σĉ²]).  The conv runs in float32 over the
    operands (bf16 products are exact in float32) and ĉ is rounded to x's
    dtype before the pools and the sums (a no-op in float32).  On the card
    it needs TF32 off.  With `group` the sums are the group's
    (`reduce_sums`)."""
    c = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), padding=1)
    pmax, pmin, sums = _pools_and_sums(c, x.dtype)
    if group is not None:
        sums = reduce_sums(sums.double(), x.shape[0], group)
    return pmax, pmin, sums


def reduce_sums(totals: torch.Tensor, b: int, group) -> torch.Tensor:
    """The (16, 2) float64 sums of this rank's `b` images → the group's sums,
    all-reduced in float64 and rounded once to float32 (the psum of
    `pallas_stem_train.py:221-224`).  The local batch sizes ride along, so
    that empty or unequal ones (which a JAX sharding cannot make) raise on
    every rank at once, none left waiting: Σb² · W = (Σb)² only where all
    are equal."""
    import torch.distributed as dist

    buf = torch.cat([totals, totals.new_tensor([[b, b * b]])])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    n, n2 = buf[STEM_CO].tolist()
    if n == 0 or n2 * world_size(group) != n * n:
        raise ValueError("the train stem across ranks needs equal, non-empty "
                         f"local batches (Σb = {n:g}, Σb² = {n2:g})")
    return buf[:STEM_CO].float()


def _pools_and_sums(c: torch.Tensor, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ĉ = c rounded to `dtype` (B, 16, H, W) → (pmax, pmin NHWC, sums)."""
    c = c.to(dtype)
    pmax = F.max_pool2d(c, 3, 2, 1)
    pmin = -F.max_pool2d(-c, 3, 2, 1)
    cf = c.float()
    sums = torch.stack([cf.sum(dim=(0, 2, 3)), (cf * cf).sum(dim=(0, 2, 3))], 1)
    return (pmax.permute(0, 2, 3, 1).contiguous(),
            pmin.permute(0, 2, 3, 1).contiguous(), sums)


def stem_train_gemm(x: torch.Tensor, weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C's arithmetic, ordered as the kernel orders it: the zero-
    padded im2col operand against the K=32 weights (rows 27-31 zero), one
    float32 matmul, ĉ rounded to x's dtype before the pools and the sums.
    Same contract as `stem_train_plain`."""
    c = stem_core.conv_gemm(x.permute(0, 3, 1, 2), weight, None, padding=1)
    return _pools_and_sums(c, x.dtype)


def stem_train(x: torch.Tensor, weight: torch.Tensor, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C on the NHWC input: (pmax, pmin, sums) as `stem_train_plain`
    returns them.  Launches the CUDA kernel for a bf16 or float32 CUDA
    tensor; a CPU tensor takes `stem_train_plain`.  The kernel runs
    `stem_core.num_ctas` persistent CTAs, each writing one (16, 2) float64
    partial of the sums; they are added here in float64, all-reduced over
    `group` in float64 where one is given (`reduce_sums`), and rounded once
    (in bf16 the local sums are then exact up to that rounding)."""
    global LAUNCHES, LAUNCHES_F32
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"x must be (B, H, W, 3), got {tuple(x.shape)}")
    b, h, w, _ = x.shape
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        raise ValueError(f"the train stem needs even H and W, got H={h}, W={w}")
    if tuple(weight.shape) != (STEM_CO, 3, 3, 3):
        raise ValueError(f"weight must be ({STEM_CO}, 3, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if x.device.type == "cpu":
        return stem_train_plain(x, weight, group)
    if x.device.type != "cuda":
        raise ValueError(f"stem_train runs on CUDA or CPU, got {x.device}")
    if x.dtype not in _ENTRIES:
        raise ValueError(f"the train stem kernel takes bf16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("weight", weight)):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {x.dtype} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    pmax = torch.empty((b, h // 2, w // 2, STEM_CO), dtype=x.dtype,
                       device=x.device)
    pmin = torch.empty_like(pmax)
    if b == 0:  # an empty rank still joins the group's all-reduce, and raises
        zeros = torch.zeros((STEM_CO, 2), dtype=torch.float64, device=x.device)
        return pmax, pmin, (zeros.float() if group is None
                            else reduce_sums(zeros, 0, group))
    lib = _build.load_library()
    entry = _ENTRIES[x.dtype]
    stream = torch.cuda.current_stream(x.device)
    if x.dtype == torch.float32 and not torch.cuda.is_current_stream_capturing():
        order_f32(stream)  # a graph's launch is ordered where it is replayed
    n_cta = stem_core.num_ctas(
        b, h, w, _build.stem_kernel_info(entry, x.device)["resident_ctas"])
    partials = torch.empty((n_cta, STEM_CO, 2), dtype=torch.float64,
                           device=x.device)
    rc = getattr(lib, entry)(
        x.data_ptr(), weight.data_ptr(), pmax.data_ptr(), pmin.data_ptr(),
        partials.data_ptr(), b, h, w, n_cta, stream.cuda_stream)
    _build.check(rc, "stem_train")
    LAUNCHES += 1
    if x.dtype == torch.float32:
        LAUNCHES_F32 += 1
    totals = partials.sum(dim=0)
    if group is not None:
        return pmax, pmin, reduce_sums(totals, b, group)
    return pmax, pmin, totals.float()


def reference_stem(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decomposition the kernel replaces (`_reference_stem`,
    `pallas_stem_train.py:257-275`): conv with compute-dtype operands,
    float32 batch statistics (mean and mean² averaged over `group`, the
    pmean of `:269-271`), normalize, ReLU, max pool.  x (B, H, W, 3) in the
    compute dtype, kernel (16, 3, 3, 3) float32 → (y (B, H/2, W/2, 16)
    NHWC, mean, var)."""
    ct = x.dtype
    c = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(ct), padding=1)
    cf = c.float()
    mean, var = batch_moments(cf, group)
    shape = (1, -1, 1, 1)
    y = ((cf - mean.view(shape)) * torch.rsqrt(var + eps).view(shape)
         * gamma.view(shape) + beta.view(shape))
    r = torch.relu(y.to(ct))
    return F.max_pool2d(r, 3, 2, 1).permute(0, 2, 3, 1), mean, var


class _FusedTrainStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, gamma, beta, eps, group):
        b, h, w, _ = x.shape
        pmax, pmin, sums = stem_train(x.contiguous(),
                                      kernel.to(x.dtype).contiguous(), group)
        n = b * h * w * world_size(group)
        mean = sums[:, 0] / n
        mean2 = sums[:, 1] / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        scale = gamma * torch.rsqrt(var + eps)
        shift = beta - mean * scale
        pooled = torch.where(scale >= 0, pmax, pmin)
        y = torch.relu((pooled.float() * scale + shift).to(x.dtype))
        ctx.save_for_backward(x, kernel, gamma, beta)
        ctx.eps, ctx.group = eps, group
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, kernel, gamma, beta = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip((x, kernel, gamma, beta), ctx.needs_input_grad[:4])]
        with torch.enable_grad():
            outs = reference_stem(*inputs, ctx.eps, ctx.group)
            wanted = [t for t, need in zip(inputs, ctx.needs_input_grad[:4]) if need]
            grads = iter(torch.autograd.grad(outs, wanted, (gy, gmean, gvar),
                                             allow_unused=True))
        return (*[next(grads) if need else None
                  for need in ctx.needs_input_grad[:4]], None, None)


def fused_train_stem(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode stem: (y, batch_mean, batch_var_biased).

    x: (B, H, W, 3) NHWC in the compute dtype, H and W even; kernel (16, 3,
    3, 3) float32 OIHW; gamma/beta (16,) float32.  y: (B, H/2, W/2, 16) NHWC
    in the compute dtype.  Differentiable with respect to x, kernel, gamma
    and beta; the gradient flows through the batch mean and variance.
    `group`: the moments are those of the group's global batch (every rank
    passes an equal local batch); the gradients of kernel, gamma and beta
    are this rank's parts of the global ones, to be summed over the ranks,
    and x's carries the other ranks' terms through the moments."""
    return _FusedTrainStem.apply(x, kernel, gamma, beta, eps, group)
