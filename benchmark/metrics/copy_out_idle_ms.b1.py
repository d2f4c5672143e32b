"""`copy_out_idle_ms.b1`: device idle ms a call inside `predictor.copy_out`, from the program's spans (`benchlib.spans.copy_out_idle_ms`)."""

from benchlib.spans import copy_out_idle_ms as read  # noqa: F401
