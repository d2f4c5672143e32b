"""`augment_ms.train`: device ms a batch of the augmentation launched inside `augment` (`benchlib.layers.augment_ms`)."""

from benchlib.layers import augment_ms as read  # noqa: F401
