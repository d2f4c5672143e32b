"""`replay_device_ms.b1`: device ms a call launched from `pipeline.replay`, from the program's spans (`benchlib.spans.replay_device_ms`)."""

from benchlib.spans import replay_device_ms as read  # noqa: F401
