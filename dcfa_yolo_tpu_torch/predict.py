"""Inference CLI of the port, the counterpart of the root `predict.py`
(reference `predict_mul.py`): modes predict / fps / dir_predict / heatmap.

    python -m dcfa_yolo_tpu_torch.predict --mode predict --rgb A.png --nir B.png

The root flags, plus `--device` (the card unless `--device cpu`).
`--stem-backend` and `--nms-backend` take the JAX names and the port's:
`xla` is the plain graph, `pallas*` the kernel (A for the stem, B for
NMS).  On the card every call runs the captured pipeline
(`infer/pipeline.py::detect_batch_graph`).  `--pair-backbones` serves the
paired graph (`models/pairing.py`) and implies `--fold-shuffle`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

# the JAX package's NMS backend names (`predict.py --nms-backend`) → the port's
NMS_NAMES = {"auto": "auto", "xla": "plain", "pallas": "kernel",
             "pallas_d": "kernel", "kernel": "kernel", "plain": "plain"}
STEM_NAMES = ("auto", "xla", "pallas", "pallas_d", "pallas_e", "pallas_f",
              "kernel", "plain")
IMAGE_EXTS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff")


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags the predict and get_map CLIs share."""
    p.add_argument("--model-path", default="",
                   help="weights: a port checkpoint, the reference's .pth / .npz "
                        "or the JAX package's .ckpt, by content "
                        "(utils/checkpoint.py::load_variables); seeded random "
                        "weights without one")
    p.add_argument("--classes-path", default="model_data/voc_classes.txt")
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--phi", default="n")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--stem-backend", default="auto", choices=STEM_NAMES,
                   help="backbone stem: kernel A (pallas*, kernel) or the plain "
                        "conv + max pool graph (xla, plain)")
    p.add_argument("--fold-shuffle", action="store_true",
                   help="serve with the channel shuffles folded into the weights")
    p.add_argument("--pair-backbones", action="store_true",
                   help="serve both backbones as one doubled-channel stream "
                        "with block-diagonal weights (models/pairing.py; "
                        "implies --fold-shuffle)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")


def make_predictor(args, **kw):
    """A `YOLOPredictor` for the shared flags (`add_model_args`)."""
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    return YOLOPredictor(
        model_path=args.model_path or None, classes_path=args.classes_path,
        input_shape=tuple(args.input_shape), phi=args.phi,
        compute_dtype=args.compute_dtype, stem=args.stem_backend,
        fold_shuffle=args.fold_shuffle or args.pair_backbones,
        pair_backbones=args.pair_backbones,
        device=args.device, **kw)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="predict",
                   choices=["predict", "fps", "dir_predict", "heatmap"])
    add_model_args(p)
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--nms-iou", type=float, default=0.3)
    p.add_argument("--rgb", default="img/sample_rgb.png",
                   help="RGB image path (predict/fps/heatmap)")
    p.add_argument("--nir", default="img/sample_nir.png",
                   help="NIR image path (predict/fps/heatmap)")
    p.add_argument("--test-interval", type=int, default=100)
    p.add_argument("--dir-origin-path", default="img/",
                   help="dir_predict: holds rgb/ and nir/ with the same names")
    p.add_argument("--dir-save-path", default="img_out/")
    p.add_argument("--heatmap-save-path", default="model_data/heatmap_vision.png")
    p.add_argument("--output", default="", help="save the annotated image here")
    p.add_argument("--nms-backend", default="auto", choices=sorted(NMS_NAMES),
                   help="greedy suppression: kernel B (pallas*, kernel) or its "
                        "plain version (xla, plain)")
    p.add_argument("--deploy", action="store_true",
                   help="serve the re-parameterized (fused RepGhost) graph")
    p.add_argument("--batch-size", type=int, default=1,
                   help="dir_predict: pairs a call (1 = per image; >1 batches "
                        "same-sized pairs, the ragged tail padded)")
    return p.parse_args(argv)


def _dir_predict(predictor, args) -> list:
    """Annotate every pair under --dir-origin-path; returns the names."""
    from PIL import Image

    from dcfa_yolo_tpu_torch.infer.predictor import pil_to_rgb_array

    os.makedirs(args.dir_save_path, exist_ok=True)
    rgb_dir = os.path.join(args.dir_origin_path, "rgb")
    nir_dir = os.path.join(args.dir_origin_path, "nir")
    names = [n for n in sorted(os.listdir(rgb_dir)) if n.lower().endswith(IMAGE_EXTS)]

    def save(name, image):
        image.save(os.path.join(args.dir_save_path, name), quality=95, subsampling=0)
        print(name)

    if args.batch_size <= 1:
        for name in names:
            save(name, predictor.detect_image(Image.open(os.path.join(rgb_dir, name)),
                                              Image.open(os.path.join(nir_dir, name))))
        return names
    # one call a batch of same-sized pairs (a graph has one static shape),
    # the ragged tail padded by repeating its last pair
    groups = {}
    for name in names:
        groups.setdefault(Image.open(os.path.join(rgb_dir, name)).size, []).append(name)
    for group in groups.values():
        for i in range(0, len(group), args.batch_size):
            chunk = group[i:i + args.batch_size]
            rgbs = [Image.open(os.path.join(rgb_dir, n)) for n in chunk]
            nirs = [Image.open(os.path.join(nir_dir, n)) for n in chunk]
            pad = args.batch_size - len(chunk)
            dets = predictor.detect_batch(
                np.stack([pil_to_rgb_array(im) for im in rgbs + [rgbs[-1]] * pad]),
                np.stack([pil_to_rgb_array(im) for im in nirs + [nirs[-1]] * pad]))
            for n, im, (boxes, scores, labels) in zip(chunk, rgbs, dets):
                save(n, predictor.draw_detections(im, boxes, scores, labels))
    return names


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI in-process; returns what it did: the mode and, by mode, the
    saved path, the seconds per call, or the annotated names."""
    args = parse_args(argv)
    if args.mode in ("predict", "fps", "heatmap") and not (args.rgb and args.nir):
        raise SystemExit(f"--mode {args.mode} needs --rgb and --nir image paths")
    from PIL import Image

    predictor = make_predictor(args, confidence=args.confidence,
                               nms_iou=args.nms_iou, deploy=args.deploy,
                               nms=NMS_NAMES[args.nms_backend])
    out = {"mode": args.mode}
    if args.mode == "predict":
        image = predictor.detect_image(Image.open(args.rgb), Image.open(args.nir))
        dest = args.output or "img_out/sample_prediction.png"
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        image.save(dest)
        print(f"saved {dest}")
        out["saved"] = dest
    elif args.mode == "fps":
        tact = predictor.get_fps(Image.open(args.rgb), Image.open(args.nir),
                                 args.test_interval)
        print(f"{tact:.6f} seconds, {1 / tact:.2f} FPS, @batch_size 1")
        out["seconds"] = tact
    elif args.mode == "dir_predict":
        out["names"] = _dir_predict(predictor, args)
    else:
        predictor.detect_heatmap(Image.open(args.rgb), Image.open(args.nir),
                                 args.heatmap_save_path)
        out["saved"] = args.heatmap_save_path
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
