"""`launches_per_step.train`: device operations launched inside `train_step`, a step (`benchlib.layers.launches_per_step`)."""

from benchlib.layers import launches_per_step as read  # noqa: F401
