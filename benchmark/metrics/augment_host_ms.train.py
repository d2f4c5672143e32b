"""`augment_host_ms.train`: host ms a batch of `device_aug.batch`, from the program's spans (`benchlib.spans.augment_host_ms`)."""

from benchlib.spans import augment_host_ms as read  # noqa: F401
