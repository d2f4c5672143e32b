"""`mfu.train`: the FLOPs the untraced window's items needed a second, per cent of the bf16 peak (`benchlib.layers.mfu`)."""

from benchlib.layers import mfu as read  # noqa: F401
