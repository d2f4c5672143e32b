"""Stem split probe: the fused eval stem (kernel A, `ops/cuda_stem.py`) and
four hand-written CUDA variants of it (`csrc/stem_probe.cu`) that drop or
overlap one of its phases, so that their times split kernel A's time into
tile load, conv and pool tree.

Port of the TPU probe `tools/stem_split_probe.py` (`call`, with the kernels
`make_kernel` and `pipe_kernel`).  The variants, with the JAX variant each
stands for:

- 'full'   (`full`): kernel A itself, `cuda_stem.stem_eval`;
- 'conv'   (`dots`): tile load + conv + bf16 round, writing the conv value
  at conv position (2i, 2j) of each pooled pixel (i, j);
- 'pool'   (`vpu`): tile load + pool tree + ReLU + stores, the conv
  replaced by bf16(((c0 + c1) + c2) + bias[co]), c the canvas channels at
  the centre tap (y+1, x+1);
- 'dblbuf' (`dblbuf`): kernel A with the next tile's canvas copied
  (cp.async) while the current tile computes;
- 'pipe'   (`pipe`): kernel A with conv warps working one tile ahead of
  pool warps (warp specialisation, two conv slots).

All take kernel A's inputs (canvas (B, 3, H+2, W+2) bf16, `fold_stem_params`
weights) and give its output shape (B, H/2, W/2, 16) bf16 NHWC.  All four
run on kernel A's core (`csrc/stem_core.cuh`: A's canvas staging, tensor-core
conv step and pool tree, on a persistent grid from
`ops/stem_core.py::num_ctas` and the kernel's resident CTAs).  'conv',
'pool' and 'dblbuf' walk A's double-buffered schedule: 'dblbuf' is A as a
launch of its own, so bit-identical to 'full'; relu('conv') <= 'full' holds
exactly; 'pool' is A with the GEMM swapped for the three adds, equal to
`pool_plain` bit for bit.  'pipe' splits A's steps between conv and pool
warps and computes every value as A does, so it is bit-identical to 'full'.
`stem_probe` launches a variant's kernel for a CUDA tensor and uses its
plain version (`PLAIN`) only for a CPU tensor; `LAUNCHES` counts each new
kernel's launches ('full' counts in `cuda_stem.LAUNCHES`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcfa_yolo_tpu_torch.device import require_kernels
from dcfa_yolo_tpu_torch.ops import _build, cuda_stem, stem_core
from dcfa_yolo_tpu_torch.ops.cuda_stem import STEM_CO, stem_eval_plain

VARIANTS = ("full", "conv", "pool", "dblbuf", "pipe")
_CODES = _build.PROBE_CODES
LAUNCHES = {name: 0 for name in _CODES}
_READY: set = set()  # CUDA device indices that passed require_kernels


def conv_plain(canvas: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain version of 'conv': the float32 conv at the even rows and
    columns (stride 2) plus bias, rounded to bf16, NHWC."""
    y = F.conv2d(canvas.float(), weight.float(), stride=2) + bias.float().view(1, -1, 1, 1)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def conv_gemm_probe(canvas: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """'conv' in the kernel's arithmetic: kernel A's GEMM form of the conv
    (`stem_core.conv_gemm`, the bias in K row 27) at the even rows and
    columns, rounded to bf16, NHWC.  Same contract as `conv_plain`."""
    y = stem_core.conv_gemm(canvas, weight, bias, padding=0)[..., ::2, ::2]
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def pool_plain(canvas: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain version of 'pool': bf16(((c0 + c1) + c2) + bias) in float32 at
    every conv position, c the canvas channels at its centre tap, then max
    pool 3x3 s2 (-inf pad), ReLU, NHWC.  `weight` is unused, as in the
    kernel."""
    c = canvas[:, :, 1:-1, 1:-1].float()
    v = ((c[:, 0:1] + c[:, 1:2]) + c[:, 2:3]) + bias.float().view(1, -1, 1, 1)
    y = torch.relu(F.max_pool2d(v.to(torch.bfloat16).float(), 3, 2, 1))
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


PLAIN = {"full": stem_eval_plain, "conv": conv_plain, "pool": pool_plain,
         "dblbuf": stem_eval_plain, "pipe": stem_eval_plain}


def stem_probe(variant: str, canvas: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Run one probe variant on kernel A's inputs → (B, H/2, W/2, 16) bf16.
    Launches the variant's CUDA kernel for a CUDA tensor (raising, naming
    sm_90, on a card the kernels are not built for); a CPU tensor takes the
    variant's plain version."""
    if variant == "full":
        return cuda_stem.stem_eval(canvas, weight, bias)
    if variant not in _CODES:
        raise ValueError(f"unknown probe variant {variant!r}; one of {VARIANTS}")
    b, h, w = cuda_stem.check_stem_inputs(canvas, weight, bias)
    if canvas.device.type == "cpu":
        return PLAIN[variant](canvas, weight, bias)
    dev = canvas.device
    if dev.index not in _READY:
        require_kernels(dev, f"stem_probe {variant!r}")
        _READY.add(dev.index)
    lib = _build.load_library()
    out = torch.empty((b, h // 2, w // 2, STEM_CO), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    resident = _build.stem_kernel_info(f"stem_probe_{variant}", dev)["resident_ctas"]
    n_cta = stem_core.num_ctas(b, h, w, resident)
    rc = lib.stem_probe_bf16(_CODES[variant], canvas.data_ptr(), weight.data_ptr(),
                             bias.data_ptr(), out.data_ptr(), b, h, w, n_cta,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"stem_probe {variant}")
    LAUNCHES[variant] += 1
    return out
