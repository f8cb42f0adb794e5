"""Structural C/C++ definition scanner (tokenizer + brace tracking).

AST-grade symbol detection without tree-sitter (the wheel is absent in this
environment; reference ships precompiled C grammars —
reference src/semcode/chunking/tree_sitter_chunker.py:25-45). Unlike a
line-regex scan, this walks a comment/string/preprocessor-stripped character
stream, so it correctly handles:

- multi-line signatures (``void\\n Klass::method(\\n int x)\\n {``),
- complex declarators (``auto* Ns::Klass::f(...) const noexcept -> T {``),
- constructors with initializer lists, destructors, ``operator()`` family,
- nested namespaces/classes (emitting qualified ``Ns::Klass::method`` names),
- control-flow parens (``if (...) {``) and array/lambda braces (ignored).

The strategy: track a scope stack driven by ``{``/``}``. At every ``{``,
classify what opened it by scanning the tokens since the previous
statement boundary — a class/struct/enum/namespace head pushes a NAMED
scope; a balanced ``(...)`` followed by qualifiers pushes a FUNCTION scope
and emits a definition; anything else is an anonymous block.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

_KEYWORD_NOT_NAME = frozenset(
    "if for while switch return sizeof catch do else new delete throw "
    "alignof decltype static_assert".split()
)
_QUALIFIERS = frozenset(
    "const noexcept override final mutable volatile &  && try".split()
)
_SCOPE_KINDS = {
    "class": "class",
    "struct": "class",
    "union": "class",
    "enum": "enum",
    "namespace": "namespace",
}

_TOKEN_RE = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*|::|->|&&|\|\||[{}()\[\];:,<>=~*&+\-!/%^.?]|\d[\w.]*"
)


def strip_noise(text: str) -> str:
    """Replace comments, string/char literals, and preprocessor directives
    with spaces, preserving every newline (token positions keep their
    lines). The char loop is the scanner's hot spot on large C++ files; an
    identical C state machine (native/featurizer.cpp semcode_strip_noise)
    handles ASCII inputs when the native library is available."""
    try:
        from ..embeddings.native import strip_noise_native

        native = strip_noise_native(text)
        if native is not None:
            return native
    except Exception:  # never let the fast path break chunking
        pass
    out = []
    i, n = 0, len(text)
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
                out.append("\n" if text[i] == "\n" else " ")
                i += 1
            if i < n:
                out.append("  ")
                i += 2
        elif ch in "\"'":
            quote = ch
            out.append(" ")
            i += 1
            while i < n and text[i] != quote:
                if text[i] == "\\" and i + 1 < n:
                    out.append("  " if text[i + 1] != "\n" else " \n")
                    i += 2
                    continue
                out.append("\n" if text[i] == "\n" else " ")
                i += 1
            if i < n:
                out.append(" ")
                i += 1
        elif ch == "#" and (i == 0 or text[i - 1] == "\n"):
            # preprocessor directive, including backslash-continued lines
            # (a '\' immediately before the newline continues the directive)
            cont = True
            while i < n and cont:
                cont = False
                while i < n and text[i] != "\n":
                    if text[i] == "\\" and i + 1 < n and text[i + 1] == "\n":
                        cont = True
                    out.append(" ")
                    i += 1
                if i < n:
                    out.append("\n")
                    i += 1
        else:
            out.append(ch)
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


def _find_signature(toks: List[Tuple[str, int]], open_idx: int):
    """Looking back from a '{' token, find a function signature.

    Returns (name, name_line) or None. Walks back over qualifiers, a
    trailing return type, and a constructor initializer list to a balanced
    (...) group; the qualified identifier before '(' is the name.
    """
    j = open_idx - 1

    def tok(idx):
        return toks[idx][0] if 0 <= idx < len(toks) else ""

    # skip constructor initializer list:  ... ) : a(x), b{y} {   — scan back
    # to the ':' that follows a ')' at depth 0, if present
    depth = 0
    scan = j
    colon = None
    while scan >= 0:
        t = tok(scan)
        if t in ("{", "}"):  # hard statement boundary: never scan past it
            break
        if t in ")]":
            depth += 1
        elif t in "([":
            if depth == 0:
                break
            depth -= 1
        elif depth == 0:
            if t == ":" and tok(scan - 1) != ":" and tok(scan + 1) != ":":
                colon = scan
                break
            if t in (";", "="):
                break
        scan -= 1
    if colon is not None and tok(colon - 1) == ")":
        j = colon - 1
    # skip qualifiers / trailing return type tokens back to ')'
    guard = 0
    while j >= 0 and tok(j) != ")" and guard < 64:
        t = tok(j)
        if t == ";" or t == "}" or t == "{":
            return None
        if t in _QUALIFIERS or t == "->" or t == "::" or t.isidentifier() \
                or t in ("<", ">", ",", "*", "&", "(", ")", "[", "]"):
            j -= 1
            guard += 1
            continue
        return None
    if j < 0 or tok(j) != ")":
        return None
    # balance back to the matching '('
    depth = 1
    j -= 1
    while j >= 0 and depth:
        t = tok(j)
        if t == ")":
            depth += 1
        elif t == "(":
            depth -= 1
        j -= 1
    if depth:
        return None
    # j now sits before '('; collect the qualified name
    parts: List[str] = []
    name_line = toks[j + 1][1] if j + 1 < len(toks) else 0
    # operator names span 1-3 symbol tokens after the 'operator' keyword
    # (==, <=, (), [], <=>, ...); scan a short window back for the keyword
    is_operator = any(tok(j - off) == "operator" for off in range(0, 4))
    if is_operator:
        # operator+ / operator() etc.: name is 'operator<sym...>'
        k = j
        while k >= 0 and tok(k) != "operator":
            k -= 1
        sym = "".join(t for t, _ in toks[k + 1 : j + 1])
        parts = ["operator" + sym]
        j = k - 1
        name_line = toks[k][1]
    else:
        if not tok(j).isidentifier() or tok(j) in _KEYWORD_NOT_NAME:
            return None
        parts = [tok(j)]
        name_line = toks[j][1]
        if tok(j - 1) == "~":  # destructor
            parts = ["~" + parts[0]]
            j -= 1
        j -= 1
    # qualified prefix  Ns::Klass::
    while tok(j) == "::" and tok(j - 1).isidentifier():
        parts.insert(0, tok(j - 1))
        j -= 2
    name = "::".join(parts)
    if parts[-1].split("::")[-1] in _KEYWORD_NOT_NAME:
        return None
    return name, name_line


def scan_c_symbols(text: str):
    """Yield (name, kind, line, indent) for C/C++ definitions in ``text``."""
    from .symbols import SymbolDef  # local import: avoid a cycle

    clean = strip_noise(text)
    lines = clean.splitlines()
    toks = _tokens_with_lines(clean)
    out: List[SymbolDef] = []
    class_names: set = set()
    # scope stack entries: (kind, name-or-None)
    stack: List[Tuple[str, str]] = []
    last_stmt = 0  # token index of the last statement boundary
    i = 0
    while i < len(toks):
        t, line = toks[i]
        if t == ";":
            last_stmt = i + 1
        elif t == "}":
            if stack:
                stack.pop()
            last_stmt = i + 1
        elif t == "{":
            # classify this brace
            head = [tt for tt, _ in toks[last_stmt:i]]
            scope_kind = None
            scope_name = None
            # earliest scope keyword wins ('enum class X' is an enum)
            hits = [(head.index(w), w) for w in _SCOPE_KINDS if w in head]
            for _, w in sorted(hits)[:1]:
                kind = _SCOPE_KINDS[w]
                if True:
                    wi = last_stmt + head.index(w)
                    # the name is the last identifier before '{' / ':' / '<'
                    k = wi + 1
                    cand = None
                    while k < i:
                        tk = toks[k][0]
                        if tk == ":" and toks[k + 1][0] != ":":
                            break  # base-class list
                        if tk.isidentifier() and tk not in ("final", "class"):
                            cand = tk
                        if tk == "<":
                            break
                        k += 1
                    if cand:
                        scope_kind, scope_name = kind, cand
                        if kind == "class":
                            class_names.add(cand)
                        ind = _indent_of(lines, toks[wi][1])
                        nm = _qualify(stack, cand)
                        out.append(SymbolDef(nm, kind, toks[wi][1], ind))
                    else:
                        scope_kind, scope_name = kind, ""
                    break
            if scope_kind is None:
                sig = _find_signature(toks, i)
                if sig is not None:
                    name, name_line = sig
                    qual = name.rsplit("::", 2)
                    kind = "function"
                    if stack and stack[-1][0] == "class":
                        kind = "method"
                    elif len(qual) >= 2 and qual[-2] in class_names:
                        kind = "method"  # out-of-line Klass::method
                    elif name.split("::")[-1].startswith("~"):
                        kind = "method"
                    out.append(
                        SymbolDef(
                            _qualify(stack, name),
                            kind,
                            name_line,
                            _indent_of(lines, name_line),
                        )
                    )
                    scope_kind, scope_name = "function", name
                else:
                    scope_kind, scope_name = "block", ""
            stack.append((scope_kind, scope_name))
            last_stmt = i + 1
        i += 1
    return out


def _qualify(stack, name: str) -> str:
    if "::" in name:
        return name  # already qualified out-of-line definition
    prefix = [nm for kind, nm in stack if kind in ("class", "namespace") and nm]
    return "::".join(prefix + [name]) if prefix else name


def _indent_of(lines: Sequence[str], line_no: int) -> int:
    if 0 <= line_no < len(lines):
        line = lines[line_no]
        return len(line) - len(line.lstrip())
    return 0
