"""Budgeted code chunking with symbol tagging.

Behavioral parity with the reference chunker (reference
src/semcode/chunking/tree_sitter_chunker.py:48-273): per-file segmentation
under line/char budgets (defaults 200 lines / 6000 chars), language guessing
by extension, per-chunk symbol tags, and a plain-text fallback that can never
fail. Improvements over the reference: splits prefer definition boundaries
(the reference splits mid-function at exact line counts), every chunk gets a
symbol (the reference tags only the first), and the scanner needs no native
grammar wheel.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence

from ..logger import get_logger
from .symbols import SymbolDef, scan_symbols, symbol_for_span

log = get_logger("chunking")

DEFAULT_MAX_LINES = 200  # reference tree_sitter_chunker.py:64
DEFAULT_MAX_CHARS = 6000  # reference tree_sitter_chunker.py:65

LANGUAGE_BY_SUFFIX = {
    ".py": "python",
    ".pyi": "python",
    ".c": "c",
    ".h": "cpp",
    ".cc": "cpp",
    ".cpp": "cpp",
    ".cxx": "cpp",
    ".hpp": "cpp",
    ".hh": "cpp",
    ".hxx": "cpp",
    ".cu": "cpp",
    ".cuh": "cpp",
    ".js": "javascript",
    ".jsx": "javascript",
    ".ts": "typescript",
    ".tsx": "typescript",
    ".md": "markdown",
    ".rst": "markdown",
    ".txt": "text",
    ".toml": "text",
    ".yaml": "text",
    ".yml": "text",
    ".json": "text",
}

CHUNKABLE_SUFFIXES = tuple(LANGUAGE_BY_SUFFIX.keys())


@dataclass
class CodeChunk:
    """One indexed unit (reference tree_sitter_chunker.py:48-57)."""

    path: Path
    language: str
    start_line: int  # 1-based, inclusive
    end_line: int  # 1-based, inclusive
    content: str
    symbol: Optional[str] = None


def guess_language(path: Path) -> Optional[str]:
    return LANGUAGE_BY_SUFFIX.get(path.suffix.lower())


class CodeChunker:
    """Segment source files into budgeted, symbol-tagged chunks."""

    def __init__(
        self,
        max_lines: int = DEFAULT_MAX_LINES,
        max_chars: int = DEFAULT_MAX_CHARS,
    ):
        self.max_lines = int(max_lines)
        self.max_chars = int(max_chars)

    # -- public API ---------------------------------------------------------

    def chunk_file(self, path: Path, language: Optional[str] = None) -> List[CodeChunk]:
        language = language or guess_language(path) or "text"
        try:
            text = path.read_text(encoding="utf-8", errors="replace")
        except OSError as exc:
            log.warning("chunk_read_failed", path=str(path), error=str(exc))
            return []
        return self.chunk_text(text, path=path, language=language)

    def chunk_text(
        self, text: str, *, path: Path, language: str
    ) -> List[CodeChunk]:
        if not text.strip():
            return []
        lines = text.splitlines()
        try:
            symbols = scan_symbols(lines, language)
        except Exception as exc:  # parser bugs degrade to plain segmentation
            log.warning("symbol_scan_failed", path=str(path), error=str(exc))
            symbols = []
        segments = self._segment(lines, symbols)
        chunks: List[CodeChunk] = []
        for start, end in segments:
            content = "\n".join(lines[start:end])
            for s_off, e_off, piece in self._split_by_chars(content):
                # real per-piece line attribution: a char-budget split of a
                # long segment must not stamp every piece with the whole
                # segment's span (the reference has that flaw — sources
                # displayed for long-line files then point at the wrong
                # lines; reference tree_sitter_chunker.py:264-273)
                piece_start = start + content.count("\n", 0, s_off)
                if e_off >= len(content):
                    # last piece: extend to the segment end (a trailing empty
                    # line contributes no characters, so char math can't see
                    # it — this keeps chunk spans tiling the file exactly)
                    piece_end = end
                else:
                    piece_end = (
                        start + content.count("\n", 0, max(e_off - 1, 0)) + 1
                    )
                chunks.append(
                    CodeChunk(
                        path=path,
                        language=language,
                        start_line=piece_start + 1,
                        end_line=piece_end,
                        content=piece,
                        symbol=symbol_for_span(symbols, piece_start, piece_end),
                    )
                )
        return chunks

    def chunk_repository(
        self,
        root: Path,
        files: Iterable[Path],
        *,
        on_file: Optional[Callable[[Path], None]] = None,
    ) -> List[CodeChunk]:
        chunks: List[CodeChunk] = []
        for f in files:
            chunks.extend(self.chunk_file(f))
            if on_file is not None:
                on_file(f)
        return chunks

    # -- segmentation ----------------------------------------------------------

    def _segment(
        self, lines: Sequence[str], symbols: Sequence[SymbolDef]
    ) -> List[tuple]:
        """Split [0, n) into line spans <= max_lines, preferring to break at
        top-level definition boundaries within the budget window."""
        n = len(lines)
        boundaries = sorted(
            {s.line for s in symbols if s.indent == 0 and s.line > 0}
        )
        spans: List[tuple] = []
        start = 0
        while start < n:
            hard_end = min(start + self.max_lines, n)
            end = hard_end
            if hard_end < n:
                # latest definition boundary inside (start+min_fill, hard_end]
                min_fill = start + self.max_lines // 4
                candidates = [b for b in boundaries if min_fill < b <= hard_end]
                if candidates:
                    end = candidates[-1]
            spans.append((start, end))
            start = end
        return spans

    def _split_by_chars(self, content: str):
        """Char-budget split of one segment (reference :264-273 semantics)."""
        if len(content) <= self.max_chars:
            yield 0, len(content), content
            return
        for i in range(0, len(content), self.max_chars):
            piece = content[i : i + self.max_chars]
            yield i, i + len(piece), piece
