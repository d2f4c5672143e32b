"""`backward_host_ms.train`: host self ms a step of `trainer.backward`, from the program's spans (`benchlib.spans.backward_host_ms`)."""

from benchlib.spans import backward_host_ms as read  # noqa: F401
