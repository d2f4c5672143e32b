"""`update_host_ms.train`: host self ms a step of `trainer.update` (optimizer and EMA), from the program's spans (`benchlib.spans.update_host_ms`)."""

from benchlib.spans import update_host_ms as read  # noqa: F401
