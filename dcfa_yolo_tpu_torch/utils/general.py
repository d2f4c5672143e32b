"""The pretrained backbone's file (reference `utils/utils.py`): the port's
copy of `dcfa_yolo_tpu/utils/general.py::download_weights`."""

from __future__ import annotations

import os

# the reference's release files of the pretrained backbones, one a phi
BACKBONE_URLS = {
    p: ("https://github.com/bubbliiiing/yolov8-pytorch/releases/download/v1.0/"
        f"yolov8_{p}_backbone_weights.pth")
    for p in "nsmlx"
}


def download_weights(phi: str, model_dir: str = "./model_data") -> str:
    """The pretrained backbone's file (`utils/utils.py:91-107`), never
    downloaded: `{model_dir}/yolov8_{phi}_backbone_weights.pth` if it is
    there, else a `FileNotFoundError` naming the release URL to fetch it
    from on a networked machine."""
    local = os.path.join(model_dir, f"yolov8_{phi}_backbone_weights.pth")
    if os.path.exists(local):
        return local
    raise FileNotFoundError(
        f"pretrained backbone not found at {local}; download it from "
        f"{BACKBONE_URLS.get(phi, '<no URL: unknown phi ' + repr(phi) + '>')} "
        "on a networked machine and place it there")
