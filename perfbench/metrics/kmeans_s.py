"""``kmeans_s``: see ``perfbench.program.kmeans_seconds``."""

from perfbench.program import kmeans_seconds as read  # noqa: F401
