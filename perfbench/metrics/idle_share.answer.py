"""``idle_share.answer``: see ``perfbench.readers.idle_share``."""

from perfbench.readers import idle_share as read  # noqa: F401
