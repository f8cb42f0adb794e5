"""Optional code2prompt heuristics hook.

Parity with the reference's optional post-processing step
(reference src/semcode/chunking/code2prompt_adapter.py:18-37): if the optional
``code2prompt`` package is importable, fill missing chunk symbols from its
structure extraction; otherwise a no-op passthrough.
"""

from __future__ import annotations

from typing import List

from .chunker import CodeChunk


def apply_code2prompt_heuristics(chunks: List[CodeChunk]) -> List[CodeChunk]:
    try:
        from code2prompt import heuristics  # type: ignore[import-not-found]
    except ImportError:
        return chunks
    for chunk in chunks:
        if chunk.symbol:
            continue
        try:
            structure = heuristics.extract_structure(chunk.content)
        except Exception:
            continue
        names = getattr(structure, "names", None) or []
        if names:
            chunk.symbol = str(names[0])
    return chunks
