"""`nms_suppress_roofline.b1`: kernel B's roofline bound over its device time a call, per cent (`benchlib.layers.nms_suppress_roofline`)."""

from benchlib.layers import nms_suppress_roofline as read  # noqa: F401
