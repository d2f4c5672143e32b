"""A small synthetic paired-VOC dataset for end-to-end runs of the port's
training CLI: the port's copy of `tools/make_synth_dataset.py`, with its
geometry and its seed (PCG64(7); bright ellipse "tomato bunches" on dark
backgrounds, 1-4 per image; NIR = channel-shuffled, scaled and noised RGB).
Ellipses are drawn with numpy, and images are written as PNG through PIL.

    python -m dcfa_yolo_tpu_torch.tools.make_synth_dataset OUT_DIR [N] [--size W H]

writes OUT_DIR/VOCdevkit/VOC2007/{Annotations, JPEGImages_rgb,
JPEGImages_nir} and OUT_DIR/model_data/voc_classes.txt; `data/voc.py` then
splits it and writes the annotation files (`image_ext=".png"`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}</annotation>
"""
OBJ = """  <object><name>tomato_bunch</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>
"""


def _fill_ellipse(img: np.ndarray, box: Tuple[int, int, int, int], color) -> None:
    """Fill the ellipse inscribed in the pixel box [x1, x2] × [y1, y2]
    (both ends inclusive), testing pixel centres."""
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2 + 1) / 2.0, (y1 + y2 + 1) / 2.0
    rx, ry = (x2 - x1 + 1) / 2.0, (y2 - y1 + 1) / 2.0
    ys, xs = np.ogrid[y1:y2 + 1, x1:x2 + 1]
    inside = ((xs + 0.5 - cx) / rx) ** 2 + ((ys + 0.5 - cy) / ry) ** 2 <= 1.0
    img[y1:y2 + 1, x1:x2 + 1][inside] = color


def make_dataset(out_dir: str, n_images: int = 24,
                 size: Tuple[int, int] = (480, 360)) -> None:
    """Write `n_images` pairs of `size` (W, H) under `out_dir`."""
    rng = np.random.Generator(np.random.PCG64(7))
    base = os.path.join(out_dir, "VOCdevkit", "VOC2007")
    for sub in ("Annotations", "JPEGImages_rgb", "JPEGImages_nir"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "model_data"), exist_ok=True)
    with open(os.path.join(out_dir, "model_data", "voc_classes.txt"), "w") as f:
        f.write("tomato_bunch\n")

    w, h = size
    for i in range(n_images):
        bg = rng.integers(10, 60)
        img = np.empty((h, w, 3), np.uint8)
        img[:] = (int(bg), int(bg * 1.2), int(bg))
        objects = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(40, 120)), int(rng.integers(40, 100))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            color = (int(rng.integers(180, 255)), int(rng.integers(30, 90)),
                     int(rng.integers(30, 90)))
            _fill_ellipse(img, (x1, y1, x1 + bw, y1 + bh), color)
            objects.append((x1, y1, x1 + bw, y1 + bh))
        arr = img.astype(np.float32)
        rgb = np.clip(arr + rng.normal(0, 8, arr.shape), 0, 255).astype(np.uint8)
        nir = np.clip(arr[..., [2, 0, 1]] * 0.9 + rng.normal(0, 10, arr.shape),
                      0, 255).astype(np.uint8)
        fid = f"{i:06d}"
        Image.fromarray(rgb).save(os.path.join(base, "JPEGImages_rgb", fid + ".png"))
        Image.fromarray(nir).save(os.path.join(base, "JPEGImages_nir", fid + ".png"))
        objs = "".join(OBJ.format(x1=o[0], y1=o[1], x2=o[2], y2=o[3]) for o in objects)
        with open(os.path.join(base, "Annotations", fid + ".xml"), "w") as f:
            f.write(XML.format(w=w, h=h, objects=objs))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="synth_data")
    p.add_argument("n_images", nargs="?", type=int, default=24)
    p.add_argument("--size", type=int, nargs=2, default=[480, 360], metavar=("W", "H"))
    args = p.parse_args(argv)
    make_dataset(args.out_dir, args.n_images, tuple(args.size))
    print(f"wrote {args.n_images} image pairs under {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
