"""Structural JavaScript/TypeScript definition scanner.

AST-grade symbol detection without tree-sitter, following the same strategy
as the C/C++ scanner (`cparse.py`): strip comments and string/template/regex
literals while preserving newlines, tokenize, then drive a scope stack with
``{``/``}`` and classify every opening brace by the tokens since the last
statement boundary. Replaces the round-2 line-regex scan, which missed
multi-line signatures, class methods, object-literal methods, and arrow
functions (reference bar: the shipped tree-sitter grammars,
reference src/semcode/chunking/tree_sitter_chunker.py:25-45).

Handles:
- ``function``/``async function``/generator declarations and expressions,
- ``class Name`` with methods (incl. ``static``/``async``/``get``/``set``/
  ``#private``/computed-free names), emitting ``Class.method``,
- ``const f = (...) => {...}`` and expression-bodied arrows,
- object-literal methods (``name(...) {``, ``name: function``, ``name: () =>``),
- TS: ``interface``/``enum``/``namespace``/``module``/``abstract class``,
  parameter/return type annotations, generics, decorators, modifiers.
"""

from __future__ import annotations

import re
from typing import List, Tuple

_KEYWORD_NOT_NAME = frozenset(
    "if for while switch return catch do else new delete throw typeof void "
    "in of instanceof yield await case default with super this".split()
)
# contextual keywords like `of`/`get`/`set` ARE legal method/property names;
# only genuine `kw (...) {` control-flow heads must never become symbols
_NOT_METHOD_NAMES = _KEYWORD_NOT_NAME - frozenset(("of",))
# tokens after which a '/' starts a regex literal, not division
_REGEX_PRECEDERS = frozenset(
    "= ( [ , ; : ! & | ? { } < > + - * % ~ ^ return typeof instanceof in of "
    "case do else yield await".split()
)
_MODIFIERS = frozenset(
    "public private protected readonly static async override abstract "
    "export default declare get set".split()
)
_SCOPE_KINDS = {
    "class": "class",
    "interface": "class",
    "enum": "enum",
    "namespace": "namespace",
    "module": "namespace",
}

_TOKEN_RE = re.compile(
    r"[A-Za-z_$#][A-Za-z0-9_$]*|=>|\.\.\.|[{}()\[\];:,<>=~*&+\-!/%^.?|@]|\d[\w.]*"
)


def strip_js_noise(text: str) -> str:
    """Replace comments, string/template/regex literals with spaces,
    preserving every newline. Template interpolation ``${...}`` is kept as
    code (it can contain arrow functions); nested template literals inside
    interpolations are handled recursively via a mode stack."""
    out: List[str] = []
    i, n = 0, len(text)
    # stack of modes: "tpl" = inside a template literal's ${ } interpolation
    depth_stack: List[int] = []  # brace depth per open interpolation
    last_tok = ""

    def blank(ch: str) -> str:
        return "\n" if ch == "\n" else " "

    while i < n:
        ch = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if ch == "/" and nxt == "/":
            while i < n and text[i] != "\n":
                out.append(" ")
                i += 1
        elif ch == "/" and nxt == "*":
            out.append("  ")
            i += 2
            while i < n and not (text[i] == "*" and i + 1 < n and text[i + 1] == "/"):
                out.append(blank(text[i]))
                i += 1
            if i < n:
                out.append("  ")
                i += 2
        elif ch in "\"'":
            quote = ch
            out.append(" ")
            i += 1
            while i < n and text[i] != quote and text[i] != "\n":
                if text[i] == "\\" and i + 1 < n:
                    out.append("  " if text[i + 1] != "\n" else " \n")
                    i += 2
                    continue
                out.append(blank(text[i]))
                i += 1
            if i < n and text[i] == quote:
                out.append(" ")
                i += 1
        elif ch == "`":
            # template literal: blank the text, keep ${...} interpolations
            out.append(" ")
            i += 1
            while i < n:
                if text[i] == "\\" and i + 1 < n:
                    out.append("  " if text[i + 1] != "\n" else " \n")
                    i += 2
                    continue
                if text[i] == "`":
                    out.append(" ")
                    i += 1
                    break
                if text[i] == "$" and i + 1 < n and text[i + 1] == "{":
                    out.append(" {")
                    i += 2
                    depth = 1
                    # interpolation body is CODE (recursively strip strings)
                    while i < n and depth:
                        c = text[i]
                        if c == "{":
                            depth += 1
                            out.append(c)
                            i += 1
                        elif c == "}":
                            depth -= 1
                            out.append(c if depth else "}")
                            i += 1
                        elif c in "\"'`":
                            # nested literal inside the interpolation: strip
                            # it with a bounded scan
                            q = c
                            out.append(" ")
                            i += 1
                            while i < n and text[i] != q:
                                if text[i] == "\\" and i + 1 < n:
                                    out.append("  ")
                                    i += 2
                                    continue
                                out.append(blank(text[i]))
                                i += 1
                            if i < n:
                                out.append(" ")
                                i += 1
                        else:
                            out.append(c)
                            i += 1
                    continue
                out.append(blank(text[i]))
                i += 1
        elif ch == "/" and last_tok in _REGEX_PRECEDERS:
            # regex literal
            out.append(" ")
            i += 1
            in_cls = False
            while i < n and text[i] != "\n":
                c = text[i]
                if c == "\\" and i + 1 < n:
                    out.append("  ")
                    i += 2
                    continue
                if c == "[":
                    in_cls = True
                elif c == "]":
                    in_cls = False
                elif c == "/" and not in_cls:
                    out.append(" ")
                    i += 1
                    break
                out.append(" ")
                i += 1
        else:
            out.append(ch)
            if not ch.isspace():
                # track the last significant token (1-char granularity is
                # enough for the regex-vs-division heuristic, plus keywords)
                if ch.isalnum() or ch in "_$":
                    m = re.match(r"[A-Za-z0-9_$]+", text[i:])
                    word = m.group(0) if m else ch
                    last_tok = word if word in _REGEX_PRECEDERS else "word"
                    # append the rest of the word verbatim
                    for j in range(1, len(word)):
                        out.append(text[i + j])
                    i += len(word)
                    continue
                last_tok = ch
            i += 1
    return "".join(out)


def _tokens_with_lines(clean: str) -> List[Tuple[str, int]]:
    toks: List[Tuple[str, int]] = []
    line = 0
    pos = 0
    for m in _TOKEN_RE.finditer(clean):
        line += clean.count("\n", pos, m.start())
        pos = m.start()
        toks.append((m.group(0), line))
    return toks


def _is_name(t: str) -> bool:
    return bool(t) and bool(re.match(r"[A-Za-z_$#]", t)) and t not in _KEYWORD_NOT_NAME


def _balance_back(toks, j, close=")", open_="("):
    """From toks[j] == close, return index of the matching open (or -1)."""
    depth = 1
    j -= 1
    while j >= 0 and depth:
        t = toks[j][0]
        if t == close:
            depth += 1
        elif t == open_:
            depth -= 1
        if depth == 0:
            return j
        j -= 1
    return -1


class _Scanner:
    def __init__(self, text: str):
        clean = strip_js_noise(text)
        self.lines = clean.splitlines()
        self.toks = _tokens_with_lines(clean)
        self.out: List = []
        self.seen = set()
        # scope stack entries: (kind, name-or-"")
        self.stack: List[Tuple[str, str]] = []

    def tok(self, idx: int) -> str:
        return self.toks[idx][0] if 0 <= idx < len(self.toks) else ""

    def _indent(self, line_no: int) -> int:
        if 0 <= line_no < len(self.lines):
            line = self.lines[line_no]
            return len(line) - len(line.lstrip())
        return 0

    def _emit(self, name: str, kind: str, line: int) -> None:
        from .symbols import SymbolDef  # local import: avoid a cycle

        prefix = [nm for k, nm in self.stack if k in ("class", "namespace") and nm]
        qual = ".".join(prefix + [name]) if prefix else name
        key = (qual, line)
        if key in self.seen:
            return
        self.seen.add(key)
        self.out.append(SymbolDef(qual, kind, line, self._indent(line)))

    def _skip_type_annotation_back(self, j: int) -> int:
        """TS: from just before '{', walk back over a ': ReturnType' group to
        the ')' that ends the parameter list. Returns the ')' index or -1."""
        guard = 0
        while j >= 0 and guard < 96:
            t = self.tok(j)
            if t == ")":
                return j
            if t in ("{", "}", ";"):
                return -1
            # type tokens: identifiers (incl. keyword-named types like
            # `void`/`typeof`), generics, arrays, unions, dots...
            if (
                bool(re.match(r"[A-Za-z_$#]", t))
                or t in ("<", ">", "[", "]", "|", "&", ".", ",", ":", "=>",
                         "?", "=")
                or t[:1].isdigit()
            ):
                j -= 1
                guard += 1
                continue
            return -1
        return -1

    def _name_before_params(self, j: int):
        """toks[j] == '(' of a parameter list: return (name_idx or -1)
        skipping a generics group ``<T, U>`` between name and '('."""
        j -= 1
        if self.tok(j) == ">":
            j = _balance_back(self.toks, j, close=">", open_="<")
            if j < 0:
                return -1
            j -= 1
        # syntactic name check only: contextual keywords (`of`, `in`) are
        # legal method names; _NOT_METHOD_NAMES filters control flow later
        return j if re.match(r"[A-Za-z_$#]", self.tok(j) or "") else -1

    def _classify_brace(self, i: int, last_stmt: int):
        toks = self.toks
        head = [tt for tt, _ in toks[last_stmt:i]]

        # ---- named scopes: class / interface / enum / namespace ----------
        hits = [(head.index(w), w) for w in _SCOPE_KINDS if w in head]
        if hits:
            wi_rel, w = sorted(hits)[0]
            wi = last_stmt + wi_rel
            k = wi + 1
            cand = None
            cand_line = toks[wi][1]
            while k < i:
                tk = toks[k][0]
                if tk in ("extends", "implements", "<", "{"):
                    break
                if _is_name(tk):
                    cand = tk
                    cand_line = toks[k][1]
                    break
                k += 1
            kind = _SCOPE_KINDS[w]
            if cand:
                self._emit(cand, kind, toks[wi][1])
                return (kind, cand)
            return (kind, "")

        # ---- arrow function with block body:  ... (args) => { ----------
        j = i - 1
        if self.tok(j) == "=>":
            name, line = self._arrow_name(j)
            if name:
                self._emit(name, self._fn_kind(), line)
                return ("function", name or "")
            return ("function", "")

        # ---- function/method:  name(args) [: T] {  /  function name() { --
        j = self._skip_type_annotation_back(i - 1)
        if j >= 0 and self.tok(j) == ")":
            op = _balance_back(self.toks, j)
            if op >= 0:
                ni = self._name_before_params(op)
                if ni >= 0:
                    name = self.tok(ni)
                    line = self.toks[ni][1]
                    if name == "function":
                        # anonymous function expression: take the assigned
                        # variable/property name if there is one
                        vn, vline = self._assigned_name(ni - 1)
                        if vn:
                            self._emit(vn, self._fn_kind(), vline)
                            return ("function", vn)
                        return ("function", "")
                    prev = self.tok(ni - 1)
                    if prev == "function" or (
                        prev == "*" and self.tok(ni - 2) == "function"
                    ):
                        self._emit(name, self._fn_kind(), line)
                        return ("function", name)
                    if prev in ("get", "set"):
                        self._emit(name, self._member_kind(), line)
                        return ("function", name)
                    # method shorthand (class body or object literal) or a
                    # control-flow keyword — filter if/for/while/switch/...
                    if name in _NOT_METHOD_NAMES or not re.match(
                        r"[A-Za-z_$#]", name
                    ):
                        return ("block", "")
                    self._emit(name, self._member_kind(), line)
                    return ("function", name)
        return ("block", "")

    def _fn_kind(self) -> str:
        return "method" if self._in_class() else "function"

    def _member_kind(self) -> str:
        return "method" if self._in_class() else "function"

    def _in_class(self) -> bool:
        return bool(self.stack) and self.stack[-1][0] == "class"

    def _assigned_name(self, j: int):
        """Scan back over '=' / ':' to a variable or property name."""
        guard = 0
        while j >= 0 and guard < 8:
            t = self.tok(j)
            if t in ("=", ":"):
                if _is_name(self.tok(j - 1)):
                    return self.tok(j - 1), self.toks[j - 1][1]
                return None, 0
            if t in ("async", "*"):
                j -= 1
                guard += 1
                continue
            return None, 0
        return None, 0

    def _arrow_name(self, arrow_idx: int):
        """toks[arrow_idx] == '=>': walk back over params to the assigned
        name (const f = async (a, b) => / f: x =>)."""
        j = arrow_idx - 1
        # TS return annotation between ')' and '=>' — a bare identifier here
        # is a single-param arrow ONLY when not preceded by ':' (else it is
        # the tail of a type like `): T =>`)
        if self.tok(j) != ")" and not (
            _is_name(self.tok(j)) and self.tok(j - 1) != ":"
        ):
            j2 = self._skip_type_annotation_back(j)
            if j2 >= 0:
                j = j2
        if self.tok(j) == ")":
            op = _balance_back(self.toks, j)
            if op < 0:
                return None, 0
            j = op - 1
            # generic arrow  <T>(x: T) =>
            if self.tok(j) == ">":
                g = _balance_back(self.toks, j, close=">", open_="<")
                if g >= 0:
                    j = g - 1
        elif _is_name(self.tok(j)):
            j -= 1  # single-param arrow without parens:  x =>
        else:
            return None, 0
        if self.tok(j) == "async":
            j -= 1
        return self._assigned_name(j)

    def scan(self):
        toks = self.toks
        last_stmt = 0
        i = 0
        while i < len(toks):
            t, _line = toks[i]
            if t in (";", ","):
                last_stmt = i + 1
            elif t == "}":
                if self.stack:
                    self.stack.pop()
                last_stmt = i + 1
            elif t == "{":
                scope = self._classify_brace(i, last_stmt)
                self.stack.append(scope)
                last_stmt = i + 1
            elif t == "=>" and self.tok(i + 1) != "{":
                # expression-bodied arrow: no brace will ever open for it
                name, line = self._arrow_name(i)
                if name:
                    self._emit(name, self._fn_kind(), line)
            i += 1
        self.out.sort(key=lambda s: s.line)
        return self.out


def scan_js_symbols(text: str):
    """Yield SymbolDefs for JavaScript/TypeScript definitions in ``text``."""
    return _Scanner(text).scan()
