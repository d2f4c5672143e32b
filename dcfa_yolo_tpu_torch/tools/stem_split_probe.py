"""Split the fused eval stem's time (kernel A) into tile load, conv and pool
tree, and test whether overlapping the phases pays: the port of
`tools/stem_split_probe.py`.

    python -m dcfa_yolo_tpu_torch.tools.stem_split_probe [batch] [--size 640]
        [--iters 20] [--device cuda|cpu]

Variants (`ops/cuda_stem_probe.py`; same inputs and output shape, so the
bytes moved cancel): full (kernel A), conv (load + conv, no pool tree),
pool (load + pool tree, the centre tap's three channels plus the bias in
place of the conv), dblbuf (persistent CTAs, next tile's canvas copied
during this one) and pipe (conv warps one tile ahead of pool warps).  If
conv + pool ≈ full, the phases run one after the other and overlapping
them is the lever; if conv ≈ full, the conv is.  All four run on kernel
A's core (its staging, tensor-core conv step and pool tree on a persistent
grid), so each differs from A in one step: conv is A with a centre sample in
place of the pool tree, pool is A with three adds in place of the GEMM,
dblbuf is A itself (A already double-buffers), and pipe is A's steps split
between conv warps and pool warps.  So pool / full and conv / full split
A's time: pool ≈ full says the load sets it, pool ≪ conv that the GEMM's
operand gathers do.

Inputs are made from seed 0 as in the JAX probe: a uint8 image batch in a
zero-bordered canvas, a N(0, 0.1) kernel and an identity BN.  For each
variant it prints the time per call (`utils/profiling.py::device_ms`:
CUDA events around `iters` launches after a warm-up; on the CPU, with
`--device cpu`, the host clock of the plain versions), µs per image, its
bound on the H100 (`variant_bound`) and, for dblbuf and pipe, whether the
output is bit-identical to full (see `run`).  Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch


def make_inputs(batch: int, size: int, device, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(canvas (B, 3, size+2, size+2) bf16, weight (16, 3, 3, 3) bf16, bias
    (16,) f32) from `seed`, as the JAX probe's `main` makes them."""
    from dcfa_yolo_tpu_torch.ops.cuda_stem import fold_stem_params

    rng = np.random.Generator(np.random.PCG64(seed))
    img = rng.integers(0, 255, (batch, size, size, 3))
    kern = rng.normal(0, 0.1, (3, 3, 3, 16)).astype(np.float32)  # HWIO
    canvas = np.zeros((batch, 3, size + 2, size + 2), np.float32)
    canvas[:, :, 1:-1, 1:-1] = img.transpose(0, 3, 1, 2)
    ones, zeros = torch.ones(16), torch.zeros(16)
    w, bias = fold_stem_params(torch.from_numpy(kern.transpose(3, 2, 0, 1)),
                               ones, zeros, zeros, ones)
    return (torch.from_numpy(canvas).to(device, torch.bfloat16), w.to(device),
            bias.to(device))


def variant_bound(variant: str, canvas: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time on the H100 for what
    `variant` computes on these inputs (`utils/profiling.py::bound`).  Every
    variant reads the whole canvas and the bias and writes the output once;
    all but pool read the weights.  Operations: the conv's multiply-adds at
    2 each on bf16 tensor cores (full, dblbuf, pipe at every conv position,
    conv at every fourth); pool's adds, 9 maxima and ReLU per output at the
    CUDA cores' float32 rate."""
    from dcfa_yolo_tpu_torch.utils.profiling import (H100_BF16_FLOPS,
                                                     H100_FP32_FLOPS, bound)

    b, _, h2, w2 = canvas.shape
    hw = b * (h2 - 2) * (w2 - 2)  # conv positions
    out = hw // 4 * 16
    nbytes = canvas.numel() * 2 + out * 2 + bias.numel() * 4
    if variant == "pool":
        return bound(nbytes, hw * (2 + 16) + out * 10, H100_FP32_FLOPS)
    nbytes += weight.numel() * 2
    convs = hw // 4 if variant == "conv" else hw
    return bound(nbytes, 2 * convs * 16 * 27, H100_BF16_FLOPS)


def run(batch: int = 128, size: int = 640, device="cuda", iters: int = 20
        ) -> Dict[str, Dict]:
    """Time every variant; returns {variant: {ms, us_per_img, bound_ms,
    bound_by, and bit_identical_to_full for dblbuf and pipe}}.

    `bit_identical_to_full` is reported, not required.  On the card it is
    True for both, as JAX dblbuf and pipe are bit-identical to JAX full:
    dblbuf is kernel A's own code as a launch of its own, and pipe runs A's
    conv step and pool, only split between warps.  On the CPU every variant
    is its plain version and it is True.  On a CUDA device that is not
    sm_90 it raises before it makes any input."""
    from dcfa_yolo_tpu_torch.device import require_kernels, resolve_device
    from dcfa_yolo_tpu_torch.ops.cuda_stem_probe import VARIANTS, stem_probe
    from dcfa_yolo_tpu_torch.utils.profiling import device_ms

    dev = resolve_device(device)
    if dev.type == "cuda":
        require_kernels(dev, "the stem split probe")
    canvas, w, bias = make_inputs(batch, size, dev)
    ref = stem_probe("full", canvas, w, bias)
    res = {}
    for variant in VARIANTS:
        r = dict(zip(("bound_ms", "bound_by"), variant_bound(variant, canvas, w, bias)))
        if variant in ("dblbuf", "pipe"):
            r["bit_identical_to_full"] = bool(torch.equal(
                stem_probe(variant, canvas, w, bias), ref))
        r["ms"] = device_ms(lambda v=variant: stem_probe(v, canvas, w, bias), iters, dev,
                            warmup=3)
        r["us_per_img"] = r["ms"] / batch * 1e3
        res[variant] = r
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.batch, args.size, args.device, args.iters)
    on_card = torch.device(args.device).type == "cuda"
    where = (torch.cuda.get_device_name(0) if on_card
             else "cpu (plain versions, host clock)")
    print(f"device: {where}  b{args.batch} {args.size}^2  (bounds: H100)")
    for variant, r in res.items():
        vs_bound = f" = {r['ms'] / r['bound_ms']:.1f}x" if on_card else ""
        same = (f"  bit-identical to full: {r['bit_identical_to_full']}"
                if "bit_identical_to_full" in r else "")
        print(f"{variant:7s}: {r['ms']:8.4f} ms  ({r['us_per_img']:7.2f} us/img)  "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}){vs_bound}{same}")
    split = (res["conv"]["ms"] + res["pool"]["ms"]) / res["full"]["ms"]
    print(f"split: (conv + pool) / full = {split:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
