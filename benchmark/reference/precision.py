"""Lower precisions for the reference.

`rounding(precision)` is a context in which the float32 result of every
operation that computes one (not a view, not an in-place update) is
rounded to `precision` and stored back in float32: the reference computed
in that precision, each operation's output rounded as a program in that
dtype rounds it.  Autograd sees the rounding as the identity, so the
gradient passes through, as a quantised operand's does.

- `fp8`: the precision control's, the step below the configuration's
  bfloat16: float8_e4m3fn (3 mantissa bits), one scale a tensor (its
  largest magnitude maps to the format's largest finite value, 448);
- `bfloat16`: the configuration's own precision, a witness of what that
  rounding alone does to the compared numbers;
- `float32`: nothing is rounded.

`ieee()` runs the enclosed float32 convolutions and matrix products
without TF32, which cuDNN would otherwise take by default.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t's fp8 value with one scale a tensor; the scaled values are clamped
    to the format's range (a cast beyond it gives NaN)."""
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / FP8_MAX
    q = torch.clamp(t / scale, -FP8_MAX, FP8_MAX)
    return q.to(torch.float8_e4m3fn).float() * scale


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _Rounding(TorchDispatchMode):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out
        return tree_map(lambda t: self.fn(t) if isinstance(t, torch.Tensor)
                        and t.dtype == torch.float32 and t.numel() else t, out)


ROUND = {"fp8": fp8, "bfloat16": bf16}


def rounding(precision: str):
    """A context computing in `precision` (module docstring)."""
    if precision == "float32":
        return contextlib.nullcontext()
    return _Rounding(ROUND[precision])


@contextlib.contextmanager
def ieee():
    """float32 convolutions and matrix products without TF32."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
