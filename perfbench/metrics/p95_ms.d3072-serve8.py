"""``p95_ms.d3072-serve8``: see ``perfbench.readers.untraced_p95_ms``."""

from perfbench.readers import untraced_p95_ms as read  # noqa: F401
