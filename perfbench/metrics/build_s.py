"""``build_s``: see ``perfbench.readers.build_seconds``."""

from perfbench.readers import build_seconds as read  # noqa: F401
