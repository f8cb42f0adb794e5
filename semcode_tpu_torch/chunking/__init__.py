"""Code chunking: budgeted segmentation with symbol tagging."""

from .chunker import CodeChunk, CodeChunker
from .code2prompt_adapter import apply_code2prompt_heuristics

__all__ = ["CodeChunk", "CodeChunker", "apply_code2prompt_heuristics"]
