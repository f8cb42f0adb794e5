"""``host_ms_per_call.serve``: see ``perfbench.program.host_ms_per_call``."""

from perfbench.program import host_ms_per_call as read  # noqa: F401
