"""VOC / COCO mAP evaluation CLI of the port, the counterpart of the root
`get_map.py` (reference `get_map_mul.py`).

    python -m dcfa_yolo_tpu_torch.get_map --model-path CKPT --vocdevkit-path VOCdevkit

map_mode: 0 = predictions, ground truth and VOC mAP; 1 = predictions only;
2 = ground truth only; 3 = VOC mAP from existing txt files; 4 = COCO AP
from existing txt files (`evalmap/coco_map.py`, no pycocotools).  The root
flags, plus `--device` (the card unless `--device cpu`).  The fixed NMS caps (`--pre-nms-topk`, `--max-det`) stand in
for the reference's uncapped NMS: where they bind, the prediction pass is
redone with raised caps (up to three attempts, each on a new predictor);
`--no-auto-raise` fails instead.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import xml.etree.ElementTree as ET
from typing import Optional, Sequence

from dcfa_yolo_tpu_torch.predict import add_model_args, make_predictor

ATTEMPTS = 3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--map-mode", type=int, default=0, choices=[0, 1, 2, 3, 4])
    add_model_args(p)
    p.add_argument("--minoverlap", type=float, default=0.5)
    p.add_argument("--confidence", type=float, default=0.001)
    p.add_argument("--nms-iou", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--vocdevkit-path", default="VOCdevkit")
    p.add_argument("--map-out-path", default="map_out")
    p.add_argument("--image-set", default="test")
    p.add_argument("--batch-size", type=int, default=1,
                   help="pairs a call in the prediction pass (>1 batches "
                        "same-sized pairs; the same txt files)")
    p.add_argument("--max-det", type=int, default=300,
                   help="per-image NMS survivor cap (the reference CLI is "
                        "uncapped; 100 is the in-training EvalCallback's)")
    p.add_argument("--pre-nms-topk", type=int, default=1024,
                   help="pre-NMS candidate cap, auto-raised when it binds")
    p.add_argument("--no-auto-raise", action="store_true",
                   help="fail instead of auto-raising bound NMS caps")
    return p.parse_args(argv)


def _prediction_pass(args, class_names, image_ids) -> dict:
    """Write detection-results/*.txt, raising the caps where they bind;
    returns the caps used and the attempts made."""
    import torch
    from PIL import Image

    voc = os.path.join(args.vocdevkit_path, "VOC2007")

    def load(image_id):
        return (Image.open(os.path.join(voc, "JPEGImages_rgb", image_id + ".png")),
                Image.open(os.path.join(voc, "JPEGImages_nir", image_id + ".png")))

    pre_nms_topk, max_det = args.pre_nms_topk, args.max_det
    attempts = []
    for _ in range(ATTEMPTS):
        predictor = make_predictor(args, confidence=args.confidence,
                                   nms_iou=args.nms_iou, max_det=max_det,
                                   pre_nms_topk=pre_nms_topk)
        print(f"Get predict result (pre_nms_topk={pre_nms_topk}, max_det={max_det}).")
        bs = args.batch_size
        if bs <= 1:
            for image_id in image_ids:
                predictor.get_map_txt(image_id, *load(image_id), class_names,
                                      args.map_out_path)
        else:
            groups = {}
            for image_id in image_ids:
                rgb, nir = load(image_id)
                groups.setdefault(rgb.size, []).append((image_id, rgb, nir))
            for group in groups.values():
                ids = [g[0] for g in group]
                rgbs = [g[1] for g in group]
                nirs = [g[2] for g in group]
                if len(group) % bs:  # pad the ragged tail: one static batch
                    pad = bs - len(group) % bs
                    rgbs += [rgbs[-1]] * pad
                    nirs += [nirs[-1]] * pad
                for i in range(0, len(rgbs), bs):
                    predictor.get_map_txt_batch(ids[i:i + bs], rgbs[i:i + bs],
                                                nirs[i:i + bs], class_names,
                                                args.map_out_path)
        cs = dict(predictor.cap_stats)
        attempts.append(dict(pre_nms_topk=pre_nms_topk, max_det=max_det, **cs))
        print(f"[caps] {cs['images']} images, max conf-candidates "
              f"{cs['max_candidates']}, pre_nms_topk bound on {cs['topk_bound']}, "
              f"max_det saturated on {cs['max_det_saturated']}")
        # each attempt serves through a new predictor: free this one's graphs
        predictor.release_graphs()
        del predictor
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if not (cs["topk_bound"] or cs["max_det_saturated"]):
            break
        if args.no_auto_raise:
            raise SystemExit(
                "[caps] fixed NMS caps bound: results deviate from the uncapped "
                "reference protocol (rerun with larger --pre-nms-topk/--max-det, "
                "or drop --no-auto-raise)")
        if cs["topk_bound"]:
            while pre_nms_topk <= cs["max_candidates"]:
                pre_nms_topk *= 2
        if cs["max_det_saturated"]:
            max_det *= 4
        print("[caps] auto-raising and redoing the prediction pass")
    print("Get predict result done.")
    return dict(pre_nms_topk=pre_nms_topk, max_det=max_det, attempts=attempts)


def _ground_truth(args, class_names, image_ids) -> None:
    """Write ground-truth/*.txt from the VOC XML annotations."""
    for image_id in image_ids:
        xml_path = os.path.join(args.vocdevkit_path, "VOC2007/Annotations",
                                image_id + ".xml")
        root = ET.parse(xml_path).getroot()
        with open(os.path.join(args.map_out_path, "ground-truth", image_id + ".txt"),
                  "w") as f:
            for obj in root.findall("object"):
                difficult = (obj.find("difficult") is not None
                             and int(obj.find("difficult").text) == 1)
                name = obj.find("name").text
                if name not in class_names:
                    continue
                bb = obj.find("bndbox")
                coords = " ".join(bb.find(t).text for t in ("xmin", "ymin", "xmax", "ymax"))
                f.write(f"{name} {coords}{' difficult' if difficult else ''}\n")


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI in-process; returns the caps and attempts of the prediction
    pass, the VOC mAP and the COCO APs, where the mode computes them."""
    args = parse_args(argv)
    from dcfa_yolo_tpu_torch.infer.predictor import get_classes

    class_names, _ = get_classes(args.classes_path)
    with open(os.path.join(args.vocdevkit_path, "VOC2007/ImageSets/Main",
                           f"{args.image_set}.txt")) as f:
        image_ids = f.read().strip().split()
    for sub in ("ground-truth", "detection-results"):
        os.makedirs(os.path.join(args.map_out_path, sub), exist_ok=True)
    out = {"map_mode": args.map_mode}
    if args.map_mode in (0, 1):
        print("Load model.")
        out.update(_prediction_pass(args, class_names, image_ids))
    if args.map_mode in (0, 2):
        print("Get ground truth result.")
        _ground_truth(args, class_names, image_ids)
        print("Get ground truth result done.")
    if args.map_mode in (0, 3):
        from dcfa_yolo_tpu_torch.evalmap.voc_map import get_map

        print("Get map.")
        # the plots need matplotlib, which not every machine has
        plots = importlib.util.find_spec("matplotlib") is not None
        if not plots:
            print("matplotlib is not installed: no plots")
        out["voc_map"] = get_map(args.minoverlap, plots,
                                 score_threshold=args.score_threshold,
                                 path=args.map_out_path)
        print("Get map done.")
    if args.map_mode == 4:
        from dcfa_yolo_tpu_torch.evalmap.coco_map import get_coco_map

        print("Get map (COCO protocol).")
        ap, ap50 = get_coco_map(class_names, path=args.map_out_path)
        print(f"AP@0.5:0.95 = {ap:.4f} | AP@0.5 = {ap50:.4f}")
        print("Get map done.")
        out["coco_ap"], out["coco_ap50"] = ap, ap50
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
