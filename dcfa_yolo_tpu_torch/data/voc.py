"""Paired-VOC dataset preparation (the port's copy of `dcfa_yolo_tpu/data/voc.py`,
counterpart of `voc_annotation_mul.py`).

Produces the same artifacts from the same layout:
  VOCdevkit/VOC2007/{Annotations/*.xml, ImageSets/Main/*.txt,
                     JPEGImages_rgb/, JPEGImages_nir/}
  → ImageSets splits (mode 1) and `2007_train.txt`/`2007_val.txt` annotation
    files (mode 2) with lines
    `{abs}/JPEGImages_rgb/{id}.jpg {abs}/JPEGImages_nir/{id}.jpg x1,y1,x2,y2,cls ...`
    skipping difficult objects.  Split sampling reproduces the reference's
    `random.seed(0)` + `random.sample` protocol so splits are identical.
"""

from __future__ import annotations

import os
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_class_names(classes_path: str) -> List[str]:
    with open(classes_path, encoding="utf-8") as f:
        return [c.strip() for c in f.readlines()]


def parse_voc_xml(xml_path: str, classes: Sequence[str],
                  keep_difficult: bool = False) -> List[Tuple[int, int, int, int, int]]:
    """→ [(xmin, ymin, xmax, ymax, cls_id)] for known, non-difficult objects."""
    root = ET.parse(xml_path).getroot()
    out = []
    for obj in root.iter("object"):
        difficult = 0
        node = obj.find("difficult")
        if node is not None:
            difficult = int(node.text)
        name = obj.find("name").text
        if name not in classes or (difficult == 1 and not keep_difficult):
            continue
        bb = obj.find("bndbox")
        coords = tuple(int(float(bb.find(k).text))
                       for k in ("xmin", "ymin", "xmax", "ymax"))
        out.append(coords + (classes.index(name),))
    return out


def generate_imagesets(devkit_path: str, trainval_percent: float = 0.9,
                       train_percent: float = 0.9, seed: int = 0,
                       year: str = "2007") -> Dict[str, int]:
    """Mode 1: write trainval/train/val/test id lists
    (`voc_annotation_mul.py:72-111`)."""
    ann_dir = os.path.join(devkit_path, f"VOC{year}", "Annotations")
    out_dir = os.path.join(devkit_path, f"VOC{year}", "ImageSets", "Main")
    os.makedirs(out_dir, exist_ok=True)
    xmls = sorted(x for x in os.listdir(ann_dir) if x.endswith(".xml"))

    rnd = random.Random(seed)
    num = len(xmls)
    tv = int(num * trainval_percent)
    tr = int(tv * train_percent)
    trainval = rnd.sample(list(range(num)), tv)
    train = rnd.sample(trainval, tr)
    trainval_set, train_set = set(trainval), set(train)

    buckets = {"trainval": [], "train": [], "val": [], "test": []}
    for i, xml in enumerate(xmls):
        name = xml[:-4]
        if i in trainval_set:
            buckets["trainval"].append(name)
            buckets["train" if i in train_set else "val"].append(name)
        else:
            buckets["test"].append(name)
    for split, names in buckets.items():
        with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
            f.write("".join(n + "\n" for n in names))
    return {k: len(v) for k, v in buckets.items()}


def generate_annotation_files(devkit_path: str, classes_path: str,
                              year: str = "2007", out_dir: str = ".",
                              sets: Sequence[str] = ("train", "val"),
                              image_ext: str = ".jpg") -> Dict[str, int]:
    """Mode 2: write `{year}_{set}.txt` annotation files + per-class counts
    (`voc_annotation_mul.py:113-155`).  `image_ext` names the image files
    (the reference's `.jpg`; the port's synthetic dataset writes `.png`)."""
    classes = read_class_names(classes_path)
    devkit_abs = os.path.abspath(devkit_path)
    if " " in devkit_abs:
        raise ValueError("dataset path must not contain spaces")
    counts = np.zeros(len(classes), dtype=np.int64)
    photo_nums = {}

    for image_set in sets:
        ids_path = os.path.join(devkit_path, f"VOC{year}", "ImageSets", "Main",
                                f"{image_set}.txt")
        with open(ids_path, encoding="utf-8") as f:
            image_ids = f.read().strip().split()
        lines = []
        for image_id in image_ids:
            rgb = f"{devkit_abs}/VOC{year}/JPEGImages_rgb/{image_id}{image_ext}"
            nir = f"{devkit_abs}/VOC{year}/JPEGImages_nir/{image_id}{image_ext}"
            xml = os.path.join(devkit_path, f"VOC{year}", "Annotations",
                               f"{image_id}.xml")
            objs = parse_voc_xml(xml, classes)
            for *_coords, cls_id in objs:
                counts[cls_id] += 1
            ann = "".join(
                " " + ",".join(map(str, o[:4])) + f",{o[4]}" for o in objs)
            lines.append(f"{rgb} {nir}{ann}\n")
        out_path = os.path.join(out_dir, f"{year}_{image_set}.txt")
        with open(out_path, "w", encoding="utf-8") as f:
            f.write("".join(lines))
        photo_nums[image_set] = len(image_ids)

    print("| " + " | ".join(classes) + " |")
    print("| " + " | ".join(str(int(c)) for c in counts) + " |")
    if photo_nums.get("train", 0) <= 500:
        print("Training set has <= 500 images; consider more epochs.")
    if counts.sum() == 0:
        print("No targets found — check classes_path or label names.")
    return {"photo_nums": photo_nums, "class_counts": counts.tolist()}
