"""`graph_pool_gib.train`: GiB the captured train step's private memory pool holds, from the program's counter `trainer.graph_pool_bytes` (`benchlib.links.graph_pool_gib`)."""

from benchlib.links import graph_pool_gib as read  # noqa: F401
