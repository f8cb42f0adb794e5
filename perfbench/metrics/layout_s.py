"""``layout_s``: see ``perfbench.program.layout_seconds``."""

from perfbench.program import layout_seconds as read  # noqa: F401
