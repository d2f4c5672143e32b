"""Training observability of the port (`dcfa_yolo_tpu/utils/callbacks.py`,
reference `utils/callbacks_mul.py`): the loss history and the in-training
mAP evaluation.  The txt files are always written; the plots are drawn
where matplotlib imports."""

from __future__ import annotations

import os
import shutil
from typing import Callable, List, Optional, Sequence

import numpy as np

from dcfa_yolo_tpu_torch.data.augment import load_rgb_u8


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is missing."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class LossHistory:
    """epoch_loss.txt / epoch_val_loss.txt / epoch_loss.png
    (`utils/callbacks_mul.py:21-63`)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.losses: List[float] = []
        self.val_loss: List[float] = []
        os.makedirs(self.log_dir, exist_ok=True)

    def append_loss(self, epoch: int, loss: float, val_loss: float) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self.losses.append(loss)
        self.val_loss.append(val_loss)
        with open(os.path.join(self.log_dir, "epoch_loss.txt"), "a") as f:
            f.write(f"{loss}\n")
        with open(os.path.join(self.log_dir, "epoch_val_loss.txt"), "a") as f:
            f.write(f"{val_loss}\n")
        self.loss_plot()

    def loss_plot(self) -> None:
        plt = _pyplot()
        if plt is None:
            return
        iters = range(len(self.losses))
        plt.figure()
        plt.plot(iters, self.losses, "red", linewidth=2, label="train loss")
        plt.plot(iters, self.val_loss, "coral", linewidth=2, label="val loss")
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend(loc="upper right")
        plt.savefig(os.path.join(self.log_dir, "epoch_loss.png"))
        plt.cla()
        plt.close("all")


class EvalCallback:
    """Periodic val-set mAP during training (`utils/callbacks_mul.py:66-216`):
    writes ground-truth and detection txt files for the val lines (conf
    0.05, NMS 0.5, top-100), computes COCO AP50 (falling back to VOC mAP50),
    appends epoch_map.txt, plots epoch_map.png, then removes the temporary
    directory.  batch_size > 1 groups same-sized val pairs into one
    pipeline call each (the last call of a group padded by repeating its
    last pair), with the same txt output."""

    def __init__(
        self,
        predictor_factory: Callable,
        class_names: Sequence[str],
        val_lines: Sequence[str],
        log_dir: str,
        map_out_path: str = ".temp_map_out",
        max_boxes: int = 100,
        confidence: float = 0.05,
        nms_iou: float = 0.5,
        min_overlap: float = 0.5,
        eval_flag: bool = True,
        period: int = 1,
        batch_size: int = 1,
    ):
        self.predictor_factory = predictor_factory
        self.class_names = list(class_names)
        self.val_lines = list(val_lines)
        self.log_dir = log_dir
        self.map_out_path = map_out_path
        self.max_boxes = max_boxes
        self.confidence = confidence
        self.nms_iou = nms_iou
        self.min_overlap = min_overlap
        self.eval_flag = eval_flag
        self.period = period
        self.batch_size = batch_size
        self.maps: List[float] = [0.0]
        self.epoches: List[int] = [0]
        if self.eval_flag:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "epoch_map.txt"), "a") as f:
                f.write("0\n")

    def on_epoch_end(self, epoch: int, variables) -> Optional[float]:
        """Evaluate after `epoch` (1-based) with `variables`, the weights the
        factory's predictor serves; None when this epoch has no eval."""
        if self.period <= 0 or not self.eval_flag or epoch % self.period != 0:
            return None
        from dcfa_yolo_tpu_torch.evalmap.coco_map import get_coco_map
        from dcfa_yolo_tpu_torch.evalmap.voc_map import get_map

        predictor = self.predictor_factory(variables, self.confidence,
                                           self.nms_iou, self.max_boxes)
        os.makedirs(os.path.join(self.map_out_path, "ground-truth"), exist_ok=True)
        os.makedirs(os.path.join(self.map_out_path, "detection-results"), exist_ok=True)
        pending = {}  # (h, w) -> [(image_id, rgb, nir)]

        def flush(group):
            ids = [g[0] for g in group]
            rgbs = [g[1] for g in group]
            nirs = [g[2] for g in group]
            if len(group) % self.batch_size:
                pad = self.batch_size - len(group) % self.batch_size
                rgbs = rgbs + [rgbs[-1]] * pad
                nirs = nirs + [nirs[-1]] * pad
            for i in range(0, len(rgbs), self.batch_size):
                predictor.get_map_txt_batch(
                    ids[i:i + self.batch_size], np.stack(rgbs[i:i + self.batch_size]),
                    np.stack(nirs[i:i + self.batch_size]), self.class_names,
                    self.map_out_path, confidence=self.confidence)

        for line in self.val_lines:
            parts = line.split()
            image_id = os.path.basename(parts[0]).split(".")[0]
            rgb, nir = load_rgb_u8(parts[0]), load_rgb_u8(parts[1])
            if self.batch_size > 1:
                pending.setdefault(rgb.shape[:2], []).append((image_id, rgb, nir))
            else:
                predictor.get_map_txt(image_id, rgb, nir, self.class_names,
                                      self.map_out_path, confidence=self.confidence)
            boxes = np.array([list(map(int, b.split(","))) for b in parts[2:]]
                             ).reshape(-1, 5)
            with open(os.path.join(self.map_out_path, "ground-truth",
                                   image_id + ".txt"), "w") as f:
                for left, top, right, bottom, obj in boxes:
                    f.write(f"{self.class_names[int(obj)]} {left} {top} "
                            f"{right} {bottom}\n")
        for group in pending.values():
            flush(group)
        try:
            temp_map = get_coco_map(self.class_names, path=self.map_out_path)[1]
        except Exception as e:  # as the JAX callback: COCO AP50, else VOC mAP50
            print(f"[eval] COCO AP failed ({e!r}); VOC mAP{self.min_overlap} instead")
            temp_map = get_map(self.min_overlap, False, path=self.map_out_path)
        self.maps.append(float(temp_map))
        self.epoches.append(epoch)
        with open(os.path.join(self.log_dir, "epoch_map.txt"), "a") as f:
            f.write(f"{temp_map}\n")
        self._plot()
        shutil.rmtree(self.map_out_path)
        return float(temp_map)

    def _plot(self) -> None:
        plt = _pyplot()
        if plt is None:
            return
        plt.figure()
        plt.plot(self.epoches, self.maps, "red", linewidth=2, label="train map")
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel(f"Map {self.min_overlap}")
        plt.title("A Map Curve")
        plt.legend(loc="upper right")
        plt.savefig(os.path.join(self.log_dir, "epoch_map.png"))
        plt.cla()
        plt.close("all")
