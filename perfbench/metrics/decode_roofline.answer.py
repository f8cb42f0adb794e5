"""``decode_roofline.answer``: see ``perfbench.model.decode_roofline``."""

from perfbench.model import decode_roofline as read  # noqa: F401
