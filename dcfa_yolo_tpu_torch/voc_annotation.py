"""Dataset-prep entry point of the port, the counterpart of the root
`voc_annotation.py` (reference `voc_annotation_mul.py`):

    python -m dcfa_yolo_tpu_torch.voc_annotation --vocdevkit-path VOCdevkit \\
        --classes-path model_data/voc_classes.txt

`--annotation-mode` 0 writes the ImageSets splits and the `2007_train.txt` /
`2007_val.txt` annotation files (into the working directory), 1 the splits
only, 2 the annotation files only.  The split sampling is the reference's
`random.seed(0)` protocol (`--seed`), through `data/voc.py`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from dcfa_yolo_tpu_torch.data.voc import generate_annotation_files, generate_imagesets


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Write the VOC splits and annotation "
                                            "files (PyTorch port)")
    p.add_argument("--annotation-mode", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--classes-path", default="model_data/voc_classes.txt")
    p.add_argument("--trainval-percent", type=float, default=0.9)
    p.add_argument("--train-percent", type=float, default=0.9)
    p.add_argument("--vocdevkit-path", default="VOCdevkit")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.annotation_mode in (0, 1):
        print("Generate txt in ImageSets.")
        sizes = generate_imagesets(args.vocdevkit_path, args.trainval_percent,
                                   args.train_percent, args.seed)
        print("train and val size", sizes["trainval"])
        print("train size", sizes["train"])
        print("Generate txt in ImageSets done.")

    if args.annotation_mode in (0, 2):
        print("Generate 2007_train.txt and 2007_val.txt for train.")
        generate_annotation_files(args.vocdevkit_path, args.classes_path)
        print("Generate 2007_train.txt and 2007_val.txt for train done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
