"""`stem_eval_roofline.b1`: kernel A's roofline bound over its device time a launch, per cent (`benchlib.layers.stem_eval_roofline`)."""

from benchlib.layers import stem_eval_roofline as read  # noqa: F401
