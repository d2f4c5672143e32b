"""`forward_host_ms.train`: host self ms a step of `trainer.forward`, from the program's spans (`benchlib.spans.forward_host_ms`)."""

from benchlib.spans import forward_host_ms as read  # noqa: F401
