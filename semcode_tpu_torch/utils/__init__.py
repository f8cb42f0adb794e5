"""Cross-cutting utilities: per-stage timing."""

from .tracing import StageTimer

__all__ = ["StageTimer"]
