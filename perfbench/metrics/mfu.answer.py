"""``mfu.answer``: see ``perfbench.model.mfu``."""

from perfbench.model import mfu as read  # noqa: F401
