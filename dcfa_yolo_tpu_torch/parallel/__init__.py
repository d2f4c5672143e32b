"""Data parallelism of the port over a torch process group
(`dcfa_yolo_tpu/parallel/`)."""
