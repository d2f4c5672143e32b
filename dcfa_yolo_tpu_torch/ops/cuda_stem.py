"""Fused eval stem: conv3x3 s1 (3→16) + folded eval-BN and /255 + maxpool3x3
s2 + ReLU, as one hand-written CUDA kernel (`csrc/stem_eval.cu`, kernel A,
on the shared core `csrc/stem_core.cuh`: the conv on the tensor cores, a
persistent double-buffered tile walk).

Port of `dcfa_yolo_tpu/ops/pallas_stem.py` (`pallas_stem`, `pallas_stem_d`,
`pallas_stem_e`, `pallas_stem_f`: one function over four TPU canvas
layouts).  The weight contract is the v4/v5 one (`fold_stem_params_e`).

`stem_eval` launches the kernel for a CUDA tensor and uses the plain version
`stem_eval_plain` only for a CPU tensor; `LAUNCHES` counts kernel launches.
`stem_eval_gemm` computes the kernel's arithmetic in plain PyTorch, in the
kernel's GEMM form (`ops/stem_core.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dcfa_yolo_tpu_torch.ops import _build, stem_core

STEM_CO = 16  # the kernel is specialised to phi='n''s 16 stem channels
LAUNCHES = 0


def fold_stem_params(kernel_oihw: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-5, input_scale: float = 1.0 / 255.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the stem conv, its eval-BN and the /255 input scale.

    Computed in float32 in the order of `fold_stem_params_e`
    (`pallas_stem.py:186-197`): a = γ/√(var+eps), w' = bf16(kernel·(a·s)),
    bias = bf16(β − mean·a).  Returns (w' (16, 3, 3, 3) bf16, bias (16,)
    float32 holding the bf16-rounded value).
    """
    a = gamma.float() / torch.sqrt(var.float() + eps)
    bias = beta.float() - mean.float() * a
    w = kernel_oihw.float() * (a * input_scale)[:, None, None, None]
    return (w.to(torch.bfloat16).contiguous(),
            bias.to(torch.bfloat16).float().contiguous())


def stem_eval_plain(canvas: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: float32 conv of the bf16 canvas
    and weights plus bias, rounded to bf16 before the max pool (-inf pad),
    then ReLU.  canvas (B, 3, H+2, W+2) → (B, H/2, W/2, 16) bf16 NHWC.
    On the card it needs TF32 off (`torch.backends.cudnn.allow_tf32`)."""
    y = F.conv2d(canvas.float(), weight.float()) + bias.float().view(1, -1, 1, 1)
    y = y.to(torch.bfloat16).float()
    y = torch.relu(F.max_pool2d(y, 3, 2, 1))
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def stem_eval_gemm(canvas: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Kernel A's arithmetic, ordered as the kernel orders it: the im2col
    operand with a ones column against the K=32 weights with the bias in row
    27, one float32 matmul, bf16 rounding before the max pool (-inf pad),
    then ReLU.  Same contract as `stem_eval_plain`."""
    y = stem_core.conv_gemm(canvas, weight, bias, padding=0)
    y = torch.relu(F.max_pool2d(y.to(torch.bfloat16).float(), 3, 2, 1))
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def check_stem_inputs(canvas: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> Tuple[int, int, int]:
    """Raise on inputs the stem kernels do not take; returns (B, H, W).
    Device, dtype and contiguity are checked for CUDA tensors only: a CPU
    tensor goes to the plain version."""
    if canvas.dim() != 4 or canvas.shape[1] != 3:
        raise ValueError(f"canvas must be (B, 3, H+2, W+2), got {tuple(canvas.shape)}")
    b, _, h2, w2 = canvas.shape
    h, w = h2 - 2, w2 - 2
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        raise ValueError(f"stem needs even H and W, got H={h}, W={w}")
    if tuple(weight.shape) != (STEM_CO, 3, 3, 3) or tuple(bias.shape) != (STEM_CO,):
        raise ValueError(f"weight must be ({STEM_CO}, 3, 3, 3) and bias "
                         f"({STEM_CO},), got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if canvas.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the stem runs on CUDA or CPU, got {canvas.device}")
    if canvas.device.type == "cuda":
        for name, t, dt in (("canvas", canvas, torch.bfloat16),
                            ("weight", weight, torch.bfloat16),
                            ("bias", bias, torch.float32)):
            if t.device != canvas.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                                 f"{canvas.device}, got {t.dtype} on {t.device}")
    return b, h, w


def stem_eval(canvas: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Fused stem on the zero-bordered raw canvas (B, 3, H+2, W+2) bf16 with
    `fold_stem_params` weights → (B, H/2, W/2, 16) bf16 NHWC.  Launches the
    CUDA kernel for a CUDA tensor; a CPU tensor takes `stem_eval_plain`."""
    global LAUNCHES
    b, h, w = check_stem_inputs(canvas, weight, bias)
    if canvas.device.type == "cpu":
        return stem_eval_plain(canvas, weight, bias)
    out = torch.empty((b, h // 2, w // 2, STEM_CO), dtype=torch.bfloat16,
                      device=canvas.device)
    if b == 0:
        return out
    lib = _build.load_library()
    resident = _build.stem_kernel_info("stem_eval", canvas.device)["resident_ctas"]
    rc = lib.stem_eval_bf16(canvas.data_ptr(), weight.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), b, h, w,
                            stem_core.num_ctas(b, h, w, resident),
                            torch.cuda.current_stream(canvas.device).cuda_stream)
    _build.check(rc, "stem_eval")
    LAUNCHES += 1
    return out
