"""`allreduce_roofline.dp4`: the ring all-reduce's least time on NVLink for the bytes the trainer all-reduced, over `allreduce_ms.dp4`, per cent (`benchlib.links.allreduce_roofline`)."""

from benchlib.links import allreduce_roofline as read  # noqa: F401
