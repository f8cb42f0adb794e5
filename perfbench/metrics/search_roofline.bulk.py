"""``search_roofline.bulk``: see ``perfbench.readers.search_roofline``."""

from perfbench.readers import search_roofline as read  # noqa: F401
