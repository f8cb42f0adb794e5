"""Lightweight structural parsing for symbol detection and split points.

The reference loads tree-sitter C grammars but uses the AST only to tag the
first chunk with a "primary symbol" and otherwise segments by line/char
budgets (reference src/semcode/chunking/tree_sitter_chunker.py:106-125,
:241-273). tree-sitter is not available in this environment, so this module
provides the same capability — plus per-chunk symbol tagging and
definition-boundary split points, which the reference lacks — with a
deterministic line-level scanner for Python and the C-family languages.
(A tree-sitter backend could slot in behind the same `scan_symbols` interface
when that wheel is available; the scanner here is the supported path.)
"""

from __future__ import annotations

import ast as _pyast
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

_PY_DEF = re.compile(r"^(\s*)(?:async\s+)?(def|class)\s+([A-Za-z_][A-Za-z0-9_]*)")

_KIND_MAP = {"def": "function", "class": "class", "struct": "class",
             "enum": "enum", "namespace": "namespace", "union": "class",
             "function": "function"}


@dataclass
class SymbolDef:
    """One top-level-ish definition found by the scanner."""

    name: str
    kind: str  # function | class | enum | namespace | method
    line: int  # 0-based
    indent: int
    end: Optional[int] = None  # 0-based last line of the scope, if known


def _scan_python_ast(text: str) -> Optional[List[SymbolDef]]:
    """Exact Python symbol scan via the stdlib compiler.

    Compared to the line-regex fallback: immune to def/class keywords inside
    strings and comments, reports decorator-aware start lines (a chunk split
    lands above the decorators, not between them and the def), and emits
    Class.method qualified names for nested definitions. Returns None on
    syntax errors (broken/partial files fall back to the regex scan)."""
    try:
        tree = _pyast.parse(text)
    except (SyntaxError, ValueError):
        return None
    out: List[SymbolDef] = []

    def visit(node, qualprefix: str, in_class: bool) -> None:
        for child in _pyast.iter_child_nodes(node):
            if isinstance(
                child,
                (_pyast.FunctionDef, _pyast.AsyncFunctionDef, _pyast.ClassDef),
            ):
                deco = getattr(child, "decorator_list", [])
                line = (deco[0].lineno if deco else child.lineno) - 1
                is_class = isinstance(child, _pyast.ClassDef)
                kind = (
                    "class"
                    if is_class
                    else ("method" if in_class else "function")
                )
                name = qualprefix + child.name
                end = (getattr(child, "end_lineno", None) or child.lineno) - 1
                out.append(
                    SymbolDef(name, kind, line, child.col_offset, end=end)
                )
                visit(child, name + ".", is_class)

    visit(tree, "", False)
    out.sort(key=lambda s: s.line)
    return out


def scan_symbols(lines: Sequence[str], language: str) -> List[SymbolDef]:
    """Find definition lines; used for symbol tagging and split points."""
    out: List[SymbolDef] = []
    if language == "python":
        exact = _scan_python_ast("\n".join(lines))
        if exact is not None:
            return exact
        for i, line in enumerate(lines):
            m = _PY_DEF.match(line)
            if m:
                indent = len(m.group(1))
                kind = _KIND_MAP[m.group(2)]
                if indent > 0 and kind == "function":
                    kind = "method"
                out.append(SymbolDef(m.group(3), kind, i, indent))
    elif language in ("cpp", "c"):
        # structural tokenizer+brace scanner (cparse.py): handles multi-line
        # signatures, out-of-line Klass::method definitions, operators,
        # constructors/destructors, and emits namespace-qualified names —
        # the round-1 line regex missed all of those
        from .cparse import scan_c_symbols

        out.extend(scan_c_symbols("\n".join(lines)))
    elif language in ("javascript", "typescript"):
        # structural tokenizer+brace scanner (jsparse.py): handles class
        # methods with qualified names, arrow functions (incl. expression
        # bodies), object-literal methods, generics/type annotations, and
        # multi-line signatures — the round-2 line regex missed all of those
        from .jsparse import scan_js_symbols

        out.extend(scan_js_symbols("\n".join(lines)))
    return out


def primary_symbol(lines: Sequence[str], language: str) -> Optional[str]:
    """Kind of the first definition in the file (parity with the reference's
    _detect_primary_symbol, tree_sitter_chunker.py:106-125)."""
    syms = scan_symbols(lines, language)
    if not syms:
        return None
    first = min(syms, key=lambda s: s.line)
    return first.kind


def symbol_for_span(
    symbols: Sequence[SymbolDef], start: int, end: int
) -> Optional[str]:
    """Best symbol name covering the [start, end) line span: the last
    definition at or before the span start whose scope still reaches it
    (scanners that know scope ends — the Python AST scan — prune symbols
    that closed before the span, so 150 lines of unrelated top-level code
    after a class no longer get tagged with its last method), else the
    first definition inside the span."""
    covering = [
        s for s in symbols
        if s.line <= start and (s.end is None or start <= s.end)
    ]
    if covering:
        return covering[-1].name
    inside = [s for s in symbols if start <= s.line < end]
    if inside:
        return inside[0].name
    return None
