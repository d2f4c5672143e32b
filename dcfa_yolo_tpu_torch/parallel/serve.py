"""Data-parallel serving: each rank serves its slice of a global batch,
collective-free (`tests/test_serving_sharded.py`; the JAX package's GSPMD
batch partition of the serving kernels, `_partitionable_stem`,
`ops/pallas_stem.py:619`, and `_partitionable_suppress`,
`ops/pallas_nms.py:217`).  Every stage is per image, so a rank's slice
through the one-process pipeline is that slice of the global result;
kernels A and B launch per rank on the local batch, as the two wrappers
launch them per shard.
"""

from __future__ import annotations

from typing import Dict

import torch

from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch, detect_batch_graph
from dcfa_yolo_tpu_torch.ops.nms import NMSResult
from dcfa_yolo_tpu_torch.parallel.mesh import shard_batch, use_device


def detect_batch_shard(model, rgb, nir, image_hw, rank: int, world: int,
                       **kw) -> NMSResult:
    """This rank's even slice of the global batch (rgb, nir, image_hw)
    through `detect_batch_graph` on a CUDA model, `detect_batch` on the
    CPU; `kw` as theirs."""
    rgb, nir, image_hw = shard_batch((rgb, nir, image_hw), rank, world)
    cuda = next(model.parameters()).device.type == "cuda"
    return (detect_batch_graph if cuda else detect_batch)(model, rgb, nir, image_hw, **kw)


def serve_rank(rank: int, world: int, group, spec: Dict) -> Dict:
    """One serving rank (a `parallel/mesh.py::run_ranks` target): the model
    `init_model(ModelConfig(**spec["cfg"]), spec["seed"], device)` serves
    its slice of the global `spec["inputs"]` (rgb, nir, image_hw) with the
    keywords `spec["kw"]`, `spec.get("calls", 1)` times.  Returns the last
    result as numpy fields and the launches of kernels A and B over all the
    calls and over the last one."""
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.ops import _build
    dev = torch.device(spec.get("device", "cpu"))
    use_device(dev)
    model = init_model(ModelConfig(**spec["cfg"]), spec.get("seed", 0), dev)
    total = {"stem_eval": 0, "nms_suppress": 0}
    for _ in range(spec.get("calls", 1)):
        before = _build.launches()
        res = detect_batch_shard(model, *spec["inputs"], rank, world, **spec["kw"])
        n = _build.launches(before)
        last = {k: n[k] for k in total}
        total = {k: total[k] + v for k, v in last.items()}
    return dict(result={f: getattr(res, f).cpu().numpy() for f in res._fields
                        if getattr(res, f) is not None},
                launches=total, replay_launches=last)
