"""Dataset + batch loader feeding fixed-shape device batches: the port's
counterpart of `dcfa_yolo_tpu/data/loader.py` (reference
`utils/dataloader_mul.py:10-81, 382-395`, `train_mul.py:275-296`).

Every batch is (rgb, nir) float32 [0, 1] NHWC plus ground truth padded to
(B, max_boxes, …).  A thread pool overlaps augmentation with device compute;
PIL, cv2 and numpy release the GIL in their heavy loops.

Unlike the JAX loader, whose workers share the global random streams (so the
augmentation depends on thread timing), each item draws from its own
generators, seeded from (seed, epoch, position in the epoch): a run repeats
itself at any worker count.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from dcfa_yolo_tpu_torch.data.augment import (load_mosaic, load_pair_letterbox,
                                              load_pair_random, mixup_pairs)


class HostBatch(NamedTuple):
    rgb: np.ndarray        # (B, H, W, 3) float32 in [0,1]
    nir: np.ndarray        # (B, H, W, 3)
    gt_boxes: np.ndarray   # (B, M, 4) xyxy pixels
    gt_labels: np.ndarray  # (B, M)
    gt_mask: np.ndarray    # (B, M)
    # (B,) 1.0 = real sample, 0.0 = repeated tail-pad duplicate
    # (drop_last=False pads ragged tails by repetition for static shapes)
    sample_mask: np.ndarray = None


def item_rngs(seed: int, epoch: int, position: int
              ) -> Tuple[np.random.RandomState, random.Random]:
    """The generators of one item: (numpy stream, Python stream), both
    seeded from (seed, epoch, position)."""
    a, b = np.random.SeedSequence([seed, epoch, position]).generate_state(2)
    return np.random.RandomState(int(a)), random.Random(int(b))


class PairedDetectionDataset:
    """Map-style dataset over annotation lines
    `rgb_path nir_path x1,y1,x2,y2,cls ...` (`voc_annotation_mul.py:121-125`)."""

    def __init__(
        self,
        annotation_lines: Sequence[str],
        input_shape: Tuple[int, int] = (640, 640),
        train: bool = True,
        mosaic: bool = True,
        mosaic_prob: float = 0.5,
        mixup: bool = True,
        mixup_prob: float = 0.5,
        special_aug_ratio: float = 0.7,
        epoch_length: int = 200,
    ):
        self.lines = [l.strip() for l in annotation_lines if l.strip()]
        self.input_shape = tuple(input_shape)
        self.train = train
        self.mosaic = mosaic and train
        self.mosaic_prob = mosaic_prob
        self.mixup = mixup and train
        self.mixup_prob = mixup_prob
        self.special_aug_ratio = special_aug_ratio
        self.epoch_length = epoch_length
        self.epoch_now = -1

    def __len__(self) -> int:
        return len(self.lines)

    def set_epoch(self, epoch: int) -> None:
        """Mosaic switches off after special_aug_ratio of training
        (`utils/dataloader_mul.py:39`)."""
        self.epoch_now = epoch

    def load(self, index: int, rng: np.random.RandomState, py_rng: random.Random
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Item `index` drawn from the given generators, in the JAX
        package's order (`data/loader.py:79-96`): mosaic with probability
        mosaic_prob early in training, then mixup with a random pair; else
        the train or the val path.  Boxes come back float32 (N, 5)."""
        index = index % len(self.lines)
        use_mosaic = (
            self.mosaic and rng.rand() < self.mosaic_prob
            and self.epoch_now < self.epoch_length * self.special_aug_ratio)
        if use_mosaic:
            lines = py_rng.sample(self.lines, 3) + [self.lines[index]]
            py_rng.shuffle(lines)
            rgb, nir, boxes = load_mosaic(lines, self.input_shape, rng)
            if self.mixup and rng.rand() < self.mixup_prob:
                other = py_rng.sample(self.lines, 1)[0]
                rgb2, nir2, boxes2 = load_pair_random(other, self.input_shape, rng)
                rgb, nir, boxes = mixup_pairs(rgb, nir, boxes, rgb2, nir2, boxes2)
        elif self.train:
            rgb, nir, boxes = load_pair_random(self.lines[index], self.input_shape, rng)
        else:
            rgb, nir, boxes = load_pair_letterbox(self.lines[index], self.input_shape, rng)
        return rgb, nir, np.asarray(boxes, np.float32).reshape(-1, 5)


class BatchLoader:
    """Iterates shuffled fixed-size batches with background prefetch."""

    def __init__(
        self,
        dataset: PairedDetectionDataset,
        batch_size: int,
        max_boxes: int = 64,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 11,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.drop_last = drop_last
        # more worker threads than cores only thrash the GIL; clamp
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        self._stats_lock = threading.Lock()
        # per-epoch accounting, reset at each __iter__ (read after the epoch)
        self.overflow_items = 0       # items whose gt exceeded max_boxes
        self.overflow_dropped = 0     # total boxes dropped by the cap
        self._busy_s = 0.0            # producer-side busy seconds (all workers)
        self._produced = 0            # batches produced this epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch of the shuffle and augmentation streams, so that a
        loader rebuilt mid-run (freeze → unfreeze batch size) continues them
        instead of replaying epoch 0's."""
        self._epoch = epoch

    # ------------------------------------------------------------------
    def _collate(self, items) -> HostBatch:
        h, w = self.dataset.input_shape
        b = len(items)
        rgb = np.empty((b, h, w, 3), np.float32)
        nir = np.empty((b, h, w, 3), np.float32)
        for j, it in enumerate(items):
            np.divide(it[0], np.float32(255.0), out=rgb[j], casting="unsafe")
            np.divide(it[1], np.float32(255.0), out=nir[j], casting="unsafe")
        gt_boxes = np.zeros((b, self.max_boxes, 4), np.float32)
        gt_labels = np.zeros((b, self.max_boxes), np.float32)
        gt_mask = np.zeros((b, self.max_boxes), np.float32)
        for j, (_, _, boxes) in enumerate(items):
            if len(boxes) > self.max_boxes:
                # keep the largest-area boxes (`data/loader.py:156-168`): a
                # fixed cap keeps shapes static; slivers carry the least signal
                area = ((boxes[:, 2] - boxes[:, 0])
                        * (boxes[:, 3] - boxes[:, 1]))
                keep = np.argsort(-area)[: self.max_boxes]
                with self._stats_lock:
                    self.overflow_items += 1
                    self.overflow_dropped += len(boxes) - self.max_boxes
                boxes = boxes[keep]
            n = len(boxes)
            if n:
                gt_boxes[j, :n] = boxes[:, :4]
                gt_labels[j, :n] = boxes[:, 4]
                gt_mask[j, :n] = (np.abs(boxes[:, :4]).sum(-1) > 0)
        sample_mask = np.ones((b,), np.float32)
        return HostBatch(rgb, nir, gt_boxes, gt_labels, gt_mask, sample_mask)

    def _make_batch(self, epoch: int, first: int, idxs: np.ndarray,
                    n_real: int) -> HostBatch:
        t0 = time.perf_counter()
        items = [self.dataset.load(int(i), *item_rngs(self.seed, epoch, first + j))
                 for j, i in enumerate(idxs)]
        out = self._collate(items)
        out.sample_mask[n_real:] = 0.0
        with self._stats_lock:
            self._busy_s += time.perf_counter() - t0
            self._produced += 1
        return out

    def throughput(self) -> Optional[float]:
        """Measured producer capacity this epoch, batches/s (busy-time based:
        what the pool could sustain if never blocked on the consumer)."""
        if not self._busy_s:
            return None
        return self._produced / (self._busy_s / self.num_workers)

    def __iter__(self) -> Iterator[HostBatch]:
        epoch = self._epoch
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:  # the JAX loader's order
            np.random.Generator(np.random.PCG64(self.seed + epoch)).shuffle(order)
        self._epoch += 1
        self.overflow_items = 0
        self.overflow_dropped = 0
        self._busy_s = 0.0
        self._produced = 0

        batches: List[Tuple[int, int, np.ndarray, int]] = []
        stop = n - n % self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            idxs = order[i:i + self.batch_size]
            n_real = len(idxs)
            if n_real < self.batch_size:
                # pad the ragged tail by repetition: a fixed batch shape;
                # sample_mask marks the repeats
                idxs = np.resize(idxs, self.batch_size)
            batches.append((epoch, i, idxs, n_real))

        # a bounded in-flight window keeps memory flat; results are yielded
        # in order
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight = deque()
            it = iter(batches)
            for args in it:
                inflight.append(pool.submit(self._make_batch, *args))
                if len(inflight) >= self.num_workers + self.prefetch:
                    break
            while inflight:
                fut = inflight.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    inflight.append(pool.submit(self._make_batch, *nxt))
                yield fut.result()
