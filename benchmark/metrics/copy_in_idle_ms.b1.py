"""`copy_in_idle_ms.b1`: device idle ms a call inside `pipeline.copy_in`, from the program's spans (`benchlib.spans.copy_in_idle_ms`)."""

from benchlib.spans import copy_in_idle_ms as read  # noqa: F401
