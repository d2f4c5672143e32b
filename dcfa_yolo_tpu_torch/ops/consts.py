"""Device copies of constants built on the host (interpolation matrices,
letterbox fills, anchor grids, shape vectors), made once per (key, dtype,
device) and then reused.

The serving path reads them on every call; built per call, each would be a
host-to-device copy, which a CUDA graph cannot capture.  A copy made while a
capture is under way raises there, so a graph's eager warm-up call, with the
same shapes, fills the cache first.  The copies are made outside inference
mode, so that the training forward can use a matrix first made by a serving
call.  Under `torch.export` a constant not yet made is made for the trace
only and not kept: the cache never holds a traced tensor.  Callers must not
write to them.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

_CACHE: Dict[Tuple[Hashable, torch.dtype, torch.device], torch.Tensor] = {}


def device_const(key: Hashable, make: Callable, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """The constant `make()` (a numpy array or a nested list of numbers) as
    a `dtype` tensor on `device`, built on the first call for `key`."""
    k = (key, dtype, torch.device(device))
    t = _CACHE.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(make(), dtype=torch.float32).to(device=device,
                                                                dtype=dtype)
        if not torch.compiler.is_exporting():
            _CACHE[k] = t
    return t
