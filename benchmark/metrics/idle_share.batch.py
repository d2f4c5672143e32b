"""`idle_share.batch`: per cent of the traced window in which the device ran nothing (`benchlib.layers.idle_share`)."""

from benchlib.layers import idle_share as read  # noqa: F401
