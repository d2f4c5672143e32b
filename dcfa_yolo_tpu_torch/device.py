"""Device selection for the port's entry points: the card by default, the CPU
only when the caller asks for it."""

from __future__ import annotations

import torch


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
