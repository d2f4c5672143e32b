"""dcfa_yolo_tpu_torch — the PyTorch/CUDA port of `dcfa_yolo_tpu` for NVIDIA
Hopper (H100, sm_90a).

The JAX package stays the reference; this package imports nothing of it and
keeps its own copies of what it needs.  Public functions keep the JAX
layouts (NHWC images and feature maps, anchors-first `(B, A, C)` outputs), so
the tests compare like with like.  Entry points run on the card unless the
caller passes `device="cpu"`; the hand-written kernels (`ops/cuda_stem.py`,
`ops/cuda_nms.py`, `ops/cuda_stem_train.py`, `ops/cuda_stem_probe.py`) are
built from `csrc/` at first use.  Ported so far: serving (`infer/`, on the
train or the deploy graph), the single-device train step (`train/`), and
the measurement entry points `bench`, `summary` and
`tools.stem_split_probe` (each run with `python -m`).
"""

__version__ = "0.1.0"

from dcfa_yolo_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig", "__version__"]
