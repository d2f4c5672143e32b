"""Device selection for the port's entry points: the card by default, the CPU
only when the caller asks for it; and the one predicate that says whether
the port's hand-written kernels run on a device."""

from __future__ import annotations

import torch

KERNEL_CAPABILITY = (9, 0)  # the kernels are built for sm_90a only (ops/_build.py)


def resolve_device(device="cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    There is no silent CPU fallback: asking for CUDA (the default) on a
    machine without a usable card raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def kernels_supported(device) -> bool:
    """Whether the port's CUDA kernels run on `device`: a CUDA device of
    compute capability (9, 0), since the library holds only `sm_90a` code.
    Every `auto` resolver picks a kernel only where this holds; an explicit
    kernel request on another CUDA card raises (`require_kernels`)."""
    dev = torch.device(device)
    return (dev.type == "cuda"
            and tuple(torch.cuda.get_device_capability(dev)) == KERNEL_CAPABILITY)


def require_kernels(device, what: str) -> None:
    """Raise unless the port's CUDA kernels run on the CUDA `device`."""
    if not kernels_supported(device):
        raise ValueError(f"{what} needs an sm_90 card (compute capability "
                         f"{KERNEL_CAPABILITY}); got {torch.device(device)}")
