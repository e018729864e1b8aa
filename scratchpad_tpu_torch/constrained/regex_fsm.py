"""Regex -> NFA -> DFA compiler for constrained decoding.

The port's copy of ``scratchpad_tpu/constrained/regex_fsm.py``.

From-scratch replacement for the grammar engines the reference delegates to
(xgrammar C++ / outlines+interegular, reference: scratchpad/constrained/) —
neither is available in this image. Supports the regex subset needed for
JSON-schema guidance and typical user regexes:

    literals, ``.``, escapes (\\d \\w \\s \\D \\W \\S, punctuation),
    classes ``[a-z0-9_]`` / ``[^...]``, groups, alternation, ``* + ? {m,n}``

The DFA is built by subset construction over character equivalence classes,
then trimmed to live states so "can this token be consumed and still reach
acceptance" is a plain transition check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# ------------------------------------------------------------------ NFA build

EPS = None  # epsilon edge marker


@dataclasses.dataclass
class _CharSet:
    """A set of chars, possibly negated (matches any char NOT in the set)."""

    chars: frozenset[str]
    negated: bool = False

    def matches(self, c: str) -> bool:
        return (c not in self.chars) if self.negated else (c in self.chars)


class _NFA:
    def __init__(self):
        self.edges: list[list[tuple[Optional[_CharSet], int]]] = []

    def new_state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, src: int, label: Optional[_CharSet], dst: int) -> None:
        self.edges[src].append((label, dst))


_DIGIT = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_SPACE = frozenset(" \t\n\r\f\v")


class _Parser:
    """Recursive-descent regex parser building a Thompson NFA."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _NFA()

    def parse(self) -> tuple[int, int]:
        start, end = self._alternation()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return start, end

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _alternation(self) -> tuple[int, int]:
        branches = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._concat())
        if len(branches) == 1:
            return branches[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for bs, be in branches:
            self.nfa.add(s, EPS, bs)
            self.nfa.add(be, EPS, e)
        return s, e

    def _concat(self) -> tuple[int, int]:
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.add(e, EPS, fs)
            e = fe
        return s, e

    def _repeat(self) -> tuple[int, int]:
        s, e = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                ns, ne = self.nfa.new_state(), self.nfa.new_state()
                self.nfa.add(ns, EPS, s)
                self.nfa.add(ns, EPS, ne)
                self.nfa.add(e, EPS, s)
                self.nfa.add(e, EPS, ne)
                s, e = ns, ne
            elif c == "+":
                self.i += 1
                ne = self.nfa.new_state()
                self.nfa.add(e, EPS, s)
                self.nfa.add(e, EPS, ne)
                e = ne
            elif c == "?":
                self.i += 1
                ns, ne = self.nfa.new_state(), self.nfa.new_state()
                self.nfa.add(ns, EPS, s)
                self.nfa.add(ns, EPS, ne)
                self.nfa.add(e, EPS, ne)
                s, e = ns, ne
            elif c == "{":
                lo, hi = self._parse_counts()
                s, e = self._expand_counts(s, e, lo, hi)
            else:
                return s, e

    def _parse_counts(self) -> tuple[int, Optional[int]]:
        j = self.p.index("}", self.i)
        body = self.p[self.i + 1 : j]
        self.i = j + 1
        if "," in body:
            lo_s, hi_s = body.split(",", 1)
            return int(lo_s or 0), (int(hi_s) if hi_s else None)
        return int(body), int(body)

    def _expand_counts(self, s, e, lo, hi):
        """a{m,n} by snapshotting the sub-NFA and cloning it."""
        frag = self._snapshot(s, e)
        chain_s, chain_e = self.nfa.new_state(), None
        cur = chain_s
        for _ in range(lo):
            fs, fe = self._clone(frag)
            self.nfa.add(cur, EPS, fs)
            cur = fe
        if hi is None:  # {m,} -> m copies + star
            fs, fe = self._clone(frag)
            ne = self.nfa.new_state()
            self.nfa.add(cur, EPS, fs)
            self.nfa.add(cur, EPS, ne)
            self.nfa.add(fe, EPS, fs)
            self.nfa.add(fe, EPS, ne)
            return chain_s, ne
        opt_ends = [cur]
        for _ in range(hi - lo):
            fs, fe = self._clone(frag)
            self.nfa.add(cur, EPS, fs)
            cur = fe
            opt_ends.append(cur)
        chain_e = self.nfa.new_state()
        for oe in opt_ends:
            self.nfa.add(oe, EPS, chain_e)
        return chain_s, chain_e

    def _snapshot(self, s, e):
        """Collect the sub-NFA reachable from s (up to e)."""
        states = set()
        stack = [s]
        while stack:
            st = stack.pop()
            if st in states:
                continue
            states.add(st)
            for _, dst in self.nfa.edges[st]:
                if dst not in states:
                    stack.append(dst)
        return (s, e, sorted(states))

    def _clone(self, frag):
        s, e, states = frag
        mapping = {st: self.nfa.new_state() for st in states}
        for st in states:
            for label, dst in self.nfa.edges[st]:
                if dst in mapping:
                    self.nfa.add(mapping[st], label, mapping[dst])
        return mapping[s], mapping[e]

    def _atom(self) -> tuple[int, int]:
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            s, e = self._alternation()
            if self._peek() != ")":
                raise ValueError("unbalanced paren")
            self.i += 1
            return s, e
        if c == "[":
            return self._edge(self._char_class())
        if c == ".":
            self.i += 1
            return self._edge(_CharSet(frozenset("\n"), negated=True))
        if c == "\\":
            return self._edge(self._escape())
        if c in "*+?{":
            raise ValueError(f"dangling quantifier at {self.i}")
        self.i += 1
        return self._edge(_CharSet(frozenset(c)))

    def _edge(self, cs: _CharSet) -> tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add(s, cs, e)
        return s, e

    def _escape(self) -> _CharSet:
        self.i += 1
        c = self.p[self.i]
        self.i += 1
        if c == "x":  # \xNN hex escape
            hx = self.p[self.i : self.i + 2]
            self.i += 2
            return _CharSet(frozenset(chr(int(hx, 16))))
        if c == "u":  # \uNNNN
            hx = self.p[self.i : self.i + 4]
            self.i += 4
            return _CharSet(frozenset(chr(int(hx, 16))))
        table = {
            "d": _CharSet(_DIGIT),
            "D": _CharSet(_DIGIT, True),
            "w": _CharSet(_WORD),
            "W": _CharSet(_WORD, True),
            "s": _CharSet(_SPACE),
            "S": _CharSet(_SPACE, True),
            "n": _CharSet(frozenset("\n")),
            "t": _CharSet(frozenset("\t")),
            "r": _CharSet(frozenset("\r")),
            "f": _CharSet(frozenset("\f")),
            "v": _CharSet(frozenset("\v")),
            "0": _CharSet(frozenset("\0")),
        }
        return table.get(c, _CharSet(frozenset(c)))

    def _char_class(self) -> _CharSet:
        assert self.p[self.i] == "["
        self.i += 1
        negated = False
        if self._peek() == "^":
            negated = True
            self.i += 1
        chars: set[str] = set()
        while self._peek() != "]":
            if self._peek() is None:
                raise ValueError("unclosed char class")
            # one item: plain char or escape (single-char escapes can open
            # a range like \x00-\x1f)
            if self._peek() == "\\":
                cs = self._escape()
                if cs.negated:
                    raise ValueError("negated escapes inside classes unsupported")
                if len(cs.chars) > 1:
                    chars |= cs.chars
                    continue
                c = next(iter(cs.chars))
            else:
                c = self.p[self.i]
                self.i += 1
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self.i += 1
                if self._peek() == "\\":
                    hi_set = self._escape()
                    hi = next(iter(hi_set.chars))
                else:
                    hi = self.p[self.i]
                    self.i += 1
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        self.i += 1
        return _CharSet(frozenset(chars), negated)


# ---------------------------------------------------------------------- DFA


class DFA:
    """Deterministic automaton over characters.

    transitions[state] is a dict char -> next plus optional OTHER key
    (``None``) for "any char not explicitly listed".
    """

    def __init__(self, transitions, initial, accepting, alphabet=frozenset()):
        self.transitions: list[dict[Optional[str], int]] = transitions
        self.initial: int = initial
        self.accepting: frozenset[int] = accepting
        # chars mentioned explicitly anywhere in the pattern; the OTHER edge
        # (key None) only covers chars OUTSIDE this set
        self.alphabet: frozenset[str] = alphabet

    def step(self, state: int, c: str) -> int:
        """-1 = dead."""
        t = self.transitions[state]
        if c in t:
            return t[c]
        if c in self.alphabet:
            return -1
        return t.get(None, -1)

    def walk(self, state: int, s: str) -> int:
        for c in s:
            state = self.step(state, c)
            if state < 0:
                return -1
        return state

    def is_accepting(self, state: int) -> bool:
        return state in self.accepting

    @property
    def num_states(self) -> int:
        return len(self.transitions)


def compile_regex(pattern: str) -> DFA:
    parser = _Parser(pattern)
    start, end = parser.parse()
    nfa = parser.nfa

    def eclose(states: frozenset[int]) -> frozenset[int]:
        out = set(states)
        stack = list(states)
        while stack:
            st = stack.pop()
            for label, dst in nfa.edges[st]:
                if label is EPS and dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return frozenset(out)

    # alphabet: all chars explicitly mentioned; everything else = OTHER
    explicit: set[str] = set()
    for edges in nfa.edges:
        for label, _ in edges:
            if label is not EPS:
                explicit |= label.chars
    alphabet = sorted(explicit)

    init = eclose(frozenset([start]))
    dfa_ids: dict[frozenset[int], int] = {init: 0}
    transitions: list[dict[Optional[str], int]] = [{}]
    work = [init]
    while work:
        cur = work.pop()
        cid = dfa_ids[cur]

        def move(pred) -> Optional[int]:
            nxt = set()
            for st in cur:
                for label, dst in nfa.edges[st]:
                    if label is not EPS and pred(label):
                        nxt.add(dst)
            if not nxt:
                return None
            closed = eclose(frozenset(nxt))
            if closed not in dfa_ids:
                dfa_ids[closed] = len(transitions)
                transitions.append({})
                work.append(closed)
            return dfa_ids[closed]

        for c in alphabet:
            dst = move(lambda l, c=c: l.matches(c))
            if dst is not None:
                transitions[cid][c] = dst
        other = move(lambda l: l.negated)
        if other is not None:
            transitions[cid][None] = other

    accepting = frozenset(
        cid for sset, cid in dfa_ids.items() if end in sset
    )
    dfa = DFA(transitions, 0, accepting, frozenset(explicit))
    return _trim_dead(dfa)


def _trim_dead(dfa: DFA) -> DFA:
    """Remove states that cannot reach acceptance (so any surviving
    transition is a safe token step)."""
    rev: dict[int, set[int]] = {i: set() for i in range(dfa.num_states)}
    for src, t in enumerate(dfa.transitions):
        for dst in t.values():
            rev[dst].add(src)
    live = set(dfa.accepting)
    work = list(live)
    while work:
        st = work.pop()
        for src in rev[st]:
            if src not in live:
                live.add(src)
                work.append(src)
    if dfa.initial not in live:
        raise ValueError("regex matches nothing")
    remap = {old: new for new, old in enumerate(sorted(live))}
    transitions = []
    for old in sorted(live):
        transitions.append(
            {
                c: remap[dst]
                for c, dst in dfa.transitions[old].items()
                if dst in live
            }
        )
    return DFA(
        transitions,
        remap[dfa.initial],
        frozenset(remap[a] for a in dfa.accepting),
        dfa.alphabet,
    )
