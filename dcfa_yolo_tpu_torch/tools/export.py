"""Export the deploy serving pipeline as a portable `torch.export` artifact:
the port's counterpart of `tools/export_stablehlo.py`.

    python -m dcfa_yolo_tpu_torch.tools.export OUT.pt2 [--model-path P]
        [--batch 8] [--size 640] [--conf 0.5] [--nms-iou 0.3]
        [--classes-path model_data/voc_classes.txt] [--phi n] [--fold-shuffle]
        [--device cuda]

The whole pipeline (uint8 pair → letterbox → dual-backbone forward on the
RepGhost-fused deploy graph, with `--fold-shuffle` its shuffles folded →
DFL decode → class-offset greedy NMS → original-image boxes) is traced by
`torch.export.export` with the weights in the program, bf16 compute, and
written by `torch.export.save`.  `torch.export.load(OUT).module()(rgb, nir,
image_hw)` runs it in a process that imports only torch, on the device it
was exported on (the card unless `--device cpu`): inputs (B, S, S, 3)
uint8 twice and (B, 2) float32 original (h, w); the output is a dict of
`NMSResult`'s fields, so no class of the port is needed to read it.

The artifact uses the plain stem and the plain NMS and holds no custom op,
as the JAX tool pins its XLA backends: the kernels stay the in-process fast
path (`YOLOPredictor`), not a dependency of the artifact.  Before writing,
the tool loads the artifact back and holds its outputs equal to the
in-process plain pipeline on seeded inputs.  Any model path
`YOLOPredictor` takes is accepted; without one the weights are seeded.
"""

from __future__ import annotations

import argparse
import io
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo


class ServePipeline(torch.nn.Module):
    """`detect_batch` on a model with the plain stem and the plain NMS,
    letterboxed, returning `NMSResult`'s fields as a dict."""

    def __init__(self, model: DCFAYolo, conf: float, nms_iou: float, max_det: int = 300):
        super().__init__()
        self.model = model
        self.kw = dict(conf_thres=conf, iou_thres=nms_iou, letterbox=True,
                       max_det=max_det, nms="plain", stem="plain")

    def forward(self, rgb: torch.Tensor, nir: torch.Tensor,
                image_hw: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detect_batch(self.model, rgb, nir, image_hw, **self.kw)._asdict()


def example_inputs(batch: int, size: int, device, seed: int = 0):
    """Seeded uint8 pairs at the model's size and their (h, w)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rgb, nir = (torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3),
                                              dtype=np.uint8)).to(device)
                for _ in range(2))
    hw = torch.full((batch, 2), float(size), dtype=torch.float32, device=device)
    return rgb, nir, hw


def run(argv: Optional[Sequence[str]] = None) -> Dict:
    """Export, check and write; returns the artifact's path, bytes, the
    export's seconds and the in-process pipeline with its check inputs."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("output")
    ap.add_argument("--model-path", default="",
                    help="weights to bake in, any format YOLOPredictor reads "
                         "(seeded weights if omitted)")
    ap.add_argument("--classes-path", default="model_data/voc_classes.txt")
    ap.add_argument("--phi", default="n")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.5)
    ap.add_argument("--nms-iou", type=float, default=0.3)
    ap.add_argument("--fold-shuffle", action="store_true",
                    help="bake in channel-shuffle folding (exact up to FP sum order)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor, get_classes

    names = (get_classes(args.classes_path)[0] if os.path.exists(args.classes_path)
             else ["object"])
    pred = YOLOPredictor(names, input_shape=(args.size, args.size), phi=args.phi,
                         compute_dtype="bfloat16", model_path=args.model_path or None,
                         deploy=True, fold_shuffle=args.fold_shuffle, device=args.device)
    pipeline = ServePipeline(pred.model, args.conf, args.nms_iou)
    inputs = example_inputs(args.batch, args.size, pred.device)
    t0 = time.perf_counter()
    # one eager call first builds the pipeline's device constants
    # (`ops/consts.py`, which keeps none made during a trace), so that the
    # trace finds them made and reuses them
    with torch.inference_mode():
        pipeline(*inputs)
    program = torch.export.export(pipeline, inputs, strict=False)
    export_seconds = time.perf_counter() - t0
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()

    # round trip: the artifact as loaded == the in-process pipeline
    check = example_inputs(args.batch, args.size, pred.device, seed=1)
    with torch.inference_mode():
        want = pipeline(*check)
        got = torch.export.load(io.BytesIO(blob)).module()(*check)
    for name in want:
        np.testing.assert_array_equal(got[name].cpu().numpy(), want[name].cpu().numpy(),
                                      err_msg=name)

    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {args.output}: {len(blob) / 1e6:.1f} MB in {export_seconds:.1f} s of "
          f"export, device {pred.device}, inputs (2x uint8[{args.batch},{args.size},"
          f"{args.size},3], float32[{args.batch},2]), round trip equal")
    return dict(path=args.output, bytes=len(blob), export_seconds=export_seconds,
                pipeline=pipeline, check_inputs=check)


if __name__ == "__main__":
    run()
