"""``search_roofline.serve``: see ``perfbench.readers.search_roofline``."""

from perfbench.readers import search_roofline as read  # noqa: F401
