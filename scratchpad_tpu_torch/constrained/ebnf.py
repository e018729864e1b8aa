"""GBNF-style EBNF grammars compiled onto the native regex DFA engine.

The port's copy of ``scratchpad_tpu/constrained/ebnf.py``.

The reference delegates EBNF to xgrammar's pushdown automata
(reference: scratchpad/constrained/xgrammar_backend.py); this engine is
DFA-based, so the supported subset is NON-RECURSIVE grammars — each rule is
inlined (memoized, bounded) into one regular expression and compiled with
``compile_regex``. Recursive rules raise a clear error instead of silently
mis-constraining. In practice most guided-decoding grammars (enums,
formats, fixed JSON shapes, command languages) are regular; truly recursive
JSON should use ``json_schema`` instead, whose depth-bounded regex
translation lives in json_schema.py.

Syntax (llama.cpp GBNF):
    root  ::= "yes" | "no" ws answer
    answer ::= [a-z]+ ("," ws [a-z]+)*
    ws    ::= [ \\t]*
Literals in double quotes (with \\n \\t \\" \\\\ \\xNN escapes), char
classes, ( ) grouping, | alternation, postfix * + ? and {m,n}, and rule
references by name. ``#`` starts a comment.
"""

from __future__ import annotations

# chars that are metacharacters in the in-repo regex dialect
_META = set("\\^$.|?*+()[]{}")
_MAX_EXPANSION = 1 << 20  # bound memoized inlining blowup


def _esc_literal(ch: str) -> str:
    if ch in _META:
        return "\\" + ch
    if ch == "\n":
        return "\\n"
    if ch == "\t":
        return "\\t"
    if ch == "\r":
        return "\\r"
    o = ord(ch)
    if o < 0x20:
        return f"\\x{o:02x}"
    return ch


class _Tok:
    __slots__ = ("kind", "val")

    def __init__(self, kind, val):
        self.kind, self.val = kind, val

    def __repr__(self):
        return f"{self.kind}:{self.val!r}"


def _tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
        elif c in " \t\r\n":
            i += 1
        elif src.startswith("::=", i):
            toks.append(_Tok("def", "::="))
            i += 3
        elif c == '"':
            i += 1
            lit = []
            while i < n and src[i] != '"':
                if src[i] == "\\":
                    e = src[i + 1]
                    if e == "x":
                        lit.append(chr(int(src[i + 2 : i + 4], 16)))
                        i += 4
                    else:
                        lit.append(
                            {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)
                        )
                        i += 2
                else:
                    lit.append(src[i])
                    i += 1
            if i >= n:
                raise ValueError("unterminated string literal in EBNF")
            i += 1
            toks.append(_Tok("lit", "".join(lit)))
        elif c == "[":
            j = i + 1
            if j < n and src[j] == "^":
                j += 1
            if j < n and src[j] == "]":  # leading ] is literal
                j += 1
            while j < n and src[j] != "]":
                j += 2 if src[j] == "\\" else 1
            if j >= n:
                raise ValueError("unterminated char class in EBNF")
            toks.append(_Tok("class", src[i : j + 1]))
            i = j + 1
        elif c == "{":
            j = src.index("}", i)
            toks.append(_Tok("bound", src[i : j + 1]))
            i = j + 1
        elif c in "()|*+?":
            toks.append(_Tok(c, c))
            i += 1
        elif c.isalpha() or c in "_-":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_-"):
                j += 1
            toks.append(_Tok("name", src[i:j]))
            i = j
        else:
            raise ValueError(f"unexpected {c!r} in EBNF at offset {i}")
    return toks


class _Cut(Exception):
    """A rule reference hit the recursion-depth bound; the enclosing
    alternative (or optional/star group) absorbs the cut."""


class _RuleParser:
    """Per-rule parser producing a regex string with rule refs inlined.

    Recursive rules unroll to ``max_depth`` nestings: at the bound, the
    self-referencing ALTERNATIVE is dropped (keeping the base cases) and
    self-references under ``*``/``?``/``{0,..}`` become empty — the
    DFA-friendly approximation of xgrammar's pushdown automata (reference:
    scratchpad/constrained/xgrammar_backend.py). max_depth=0 keeps the
    strict non-recursive behavior (clear error on cycles)."""

    def __init__(
        self,
        rules: dict[str, list[_Tok]],
        cache: dict,
        max_depth: int = 0,
    ):
        self.rules = rules
        self.cache = cache  # (name, nesting_count) -> regex
        self.max_depth = max_depth
        self.stack: list[str] = []

    def expand(self, name: str) -> str:
        cnt = self.stack.count(name)
        key = (name, cnt)
        if key in self.cache:
            return self.cache[key]
        if cnt > 0 and cnt >= self.max_depth:
            if self.max_depth == 0:
                cycle = " -> ".join(self.stack + [name])
                raise ValueError(
                    f"recursive EBNF rule ({cycle}): this engine compiles "
                    "grammars to a DFA; recursion unrolls to a bounded depth "
                    "only when max_depth > 0 (auto by default), or use "
                    "json_schema for recursive JSON structures"
                )
            raise _Cut(name)
        if name not in self.rules:
            raise ValueError(f"EBNF rule {name!r} is not defined")
        self.stack.append(name)
        try:
            toks = self.rules[name]
            regex = self._alternation(toks, [0])
        finally:
            self.stack.pop()
        if len(regex) > _MAX_EXPANSION:
            raise ValueError(f"EBNF rule {name!r} expands past the size bound")
        self.cache[key] = regex
        return regex

    # -- syntactic skipping (no expansion) used to recover from a _Cut

    @staticmethod
    def _skip_to_alt(toks, pos) -> None:
        depth = 0
        while pos[0] < len(toks):
            k = toks[pos[0]].kind
            if k == "(":
                depth += 1
            elif k == ")":
                if depth == 0:
                    return
                depth -= 1
            elif k == "|" and depth == 0:
                return
            pos[0] += 1

    @staticmethod
    def _skip_atom(toks, pos) -> None:
        k = toks[pos[0]].kind
        pos[0] += 1
        if k == "(":
            depth = 1
            while pos[0] < len(toks) and depth:
                if toks[pos[0]].kind == "(":
                    depth += 1
                elif toks[pos[0]].kind == ")":
                    depth -= 1
                pos[0] += 1

    def _alternation(self, toks, pos) -> str:
        parts: list[str] = []
        while True:
            start = pos[0]
            try:
                parts.append(self._concat(toks, pos))
            except _Cut:
                pos[0] = start
                self._skip_to_alt(toks, pos)  # drop this alternative
            if pos[0] < len(toks) and toks[pos[0]].kind == "|":
                pos[0] += 1
                continue
            break
        if not parts:
            raise _Cut("all alternatives recursed")
        return "|".join(parts) if len(parts) > 1 else parts[0]

    def _concat(self, toks, pos) -> str:
        out = []
        while pos[0] < len(toks) and toks[pos[0]].kind not in ("|", ")"):
            start = pos[0]
            try:
                out.append(self._postfix(toks, pos))
            except _Cut:
                pos[0] = start
                self._skip_atom(toks, pos)
                optional = False
                while pos[0] < len(toks) and toks[pos[0]].kind in (
                    "*", "+", "?", "bound",
                ):
                    t = toks[pos[0]]
                    if t.kind in ("*", "?") or (
                        t.kind == "bound" and t.val.startswith("{0")
                    ):
                        optional = True
                    pos[0] += 1
                if not optional:
                    raise  # the whole concatenation requires the cut rule
        return "".join(out)

    def _postfix(self, toks, pos) -> str:
        base = self._atom(toks, pos)
        while pos[0] < len(toks) and toks[pos[0]].kind in ("*", "+", "?", "bound"):
            t = toks[pos[0]]
            pos[0] += 1
            op = t.val if t.kind != "bound" else t.val
            base = f"(?:{base}){op}"
        return base

    def _atom(self, toks, pos) -> str:
        t = toks[pos[0]]
        pos[0] += 1
        if t.kind == "lit":
            return "".join(_esc_literal(c) for c in t.val)
        if t.kind == "class":
            return t.val
        if t.kind == "name":
            return f"(?:{self.expand(t.val)})"
        if t.kind == "(":
            inner = self._alternation(toks, pos)
            if pos[0] >= len(toks) or toks[pos[0]].kind != ")":
                raise ValueError("unbalanced paren in EBNF")
            pos[0] += 1
            return f"(?:{inner})"
        raise ValueError(f"unexpected token {t} in EBNF rule body")


def ebnf_to_regex(src: str, root: str = "root", max_depth=None) -> str:
    """Compile a GBNF grammar source to one regex.

    Non-recursive grammars compile exactly. Recursive rules unroll to a
    bounded nesting depth (``max_depth``; default: the deepest of 6..1 whose
    expansion fits the size bound) — structures nested deeper than the bound
    are rejected by the DFA, which is the price of running without a
    pushdown automaton (reference: xgrammar)."""
    if max_depth is None:
        last: Exception = ValueError("ebnf compile failed")
        for d in (6, 5, 4, 3, 2, 1):
            try:
                return ebnf_to_regex(src, root, max_depth=d)
            except ValueError as e:
                if "size bound" not in str(e):
                    raise
                last = e
        raise last
    toks = _tokenize(src)
    # split into rules at `name ::=` boundaries
    rules: dict[str, list[_Tok]] = {}
    i = 0
    while i < len(toks):
        if (
            i + 1 < len(toks)
            and toks[i].kind == "name"
            and toks[i + 1].kind == "def"
        ):
            name = toks[i].val
            i += 2
            body: list[_Tok] = []
            depth = 0
            while i < len(toks):
                if toks[i].kind == "(":
                    depth += 1
                elif toks[i].kind == ")":
                    depth -= 1
                if (
                    depth == 0
                    and i + 1 < len(toks)
                    and toks[i].kind == "name"
                    and toks[i + 1].kind == "def"
                ):
                    break
                body.append(toks[i])
                i += 1
            if not body:
                raise ValueError(f"empty EBNF rule {name!r}")
            rules[name] = body
        else:
            raise ValueError(f"expected 'name ::=' at token {toks[i]}")
    if root not in rules:
        raise ValueError(f"EBNF grammar has no {root!r} rule")
    try:
        return _RuleParser(rules, {}, max_depth=max_depth).expand(root)
    except _Cut:
        raise ValueError(
            f"EBNF root rule {root!r} has no non-recursive base case"
        ) from None