"""`loss_host_ms.train`: host self ms a step of `trainer.loss`, from the program's spans (`benchlib.spans.loss_host_ms`)."""

from benchlib.spans import loss_host_ms as read  # noqa: F401
