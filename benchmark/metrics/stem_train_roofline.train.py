"""`stem_train_roofline.train`: kernel C's roofline bound over its device time a launch, per cent (`benchlib.layers.stem_train_roofline`)."""

from benchlib.layers import stem_train_roofline as read  # noqa: F401
