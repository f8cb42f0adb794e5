"""Query pipeline: retrieve -> prompt -> LLM (or extractive fallback)."""

from .pipeline import SemanticSearchPipeline

__all__ = ["SemanticSearchPipeline"]
