"""``launches_per_call.serve``: see ``perfbench.readers.launches_per_call``."""

from perfbench.readers import launches_per_call as read  # noqa: F401
