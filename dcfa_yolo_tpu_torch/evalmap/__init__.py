"""mAP over the reference's text-file protocol (VOC and COCO AP), numpy only."""

from dcfa_yolo_tpu_torch.evalmap.voc_map import get_map
from dcfa_yolo_tpu_torch.evalmap.coco_map import get_coco_map

__all__ = ["get_map", "get_coco_map"]
