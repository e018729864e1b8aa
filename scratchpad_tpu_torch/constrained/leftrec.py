"""Exact left-recursion elimination for EBNF grammars (Paull's algorithm,
closed-form in EBNF because ``*`` exists).

The port's copy of ``scratchpad_tpu/constrained/leftrec.py``.

The pushdown engine (pda.py) is exact for right/self recursion but a
left-recursive rule grows its call closure without consuming input, so PDA
compilation raises. This module rewrites the grammar to an equivalent one
with no left recursion — the language is preserved exactly (parse trees are
not, which is irrelevant for token masking) — so left-recursive grammars
get exact enforcement instead of the DFA engine's bounded unroll
(reference capability: xgrammar handles these natively,
scratchpad/constrained/xgrammar_backend.py).

  A ::= A a1 | .. | A am | b1 | .. | bn
    ->  A ::= ( b1 | .. | bn ) ( a1 | .. | am )*

Indirect cycles are reduced to the direct case by Paull substitution in a
fixed rule order; nullable or grouped left prefixes are first expanded so
every alternative's left edge is a plain atom. Expansion is capped — a
grammar that explodes falls back to the caller's bounded unroll.
"""

from __future__ import annotations

from scratchpad_tpu_torch.constrained.ebnf import _Tok, _tokenize

_MAX_ALTS = 256  # per-rule alternative cap during normalization


class Atom:
    __slots__ = ("kind", "val", "suffix")

    def __init__(self, kind, val, suffix=""):
        self.kind = kind  # lit | class | ref | group
        self.val = val  # str | str | str | list[Seq]
        self.suffix = suffix  # '' | '*' | '+' | '?' | '{m,n}'

    def clone(self):
        v = [list(s) for s in self.val] if self.kind == "group" else self.val
        return Atom(self.kind, v, self.suffix)


# Seq = list[Atom]; Alts = list[Seq]


def _parse_alts(toks, i=0, stop=(")",)):
    alts, seq = [], []
    while i < len(toks):
        t = toks[i]
        if t.kind in stop:
            break
        if t.kind == "|":
            alts.append(seq)
            seq = []
            i += 1
            continue
        if t.kind == "(":
            inner, i = _parse_alts(toks, i + 1)
            if i >= len(toks) or toks[i].kind != ")":
                raise ValueError("unbalanced paren in EBNF rule")
            i += 1
            atom = Atom("group", inner)
        elif t.kind in ("lit", "class", "name"):
            atom = Atom("ref" if t.kind == "name" else t.kind, t.val)
            i += 1
        else:
            raise ValueError(f"unexpected token {t} in EBNF rule body")
        if i < len(toks) and toks[i].kind in ("*", "+", "?", "bound"):
            atom.suffix = toks[i].val
            i += 1
        seq.append(atom)
    alts.append(seq)
    return alts, i


def _esc_lit(s: str) -> str:
    out = []
    for c in s:
        if c == "\\":
            out.append("\\\\")
        elif c == '"':
            out.append('\\"')
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif c == "\r":
            out.append("\\r")
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def _ser_atom(a: Atom) -> str:
    if a.kind == "lit":
        core = _esc_lit(a.val)
    elif a.kind == "class":
        core = a.val
    elif a.kind == "ref":
        core = a.val
    else:
        core = "(" + _ser_alts(a.val) + ")"
    return core + a.suffix


def _ser_seq(seq) -> str:
    if not seq:
        return '""'  # epsilon
    return " ".join(_ser_atom(a) for a in seq)


def _ser_alts(alts) -> str:
    return " | ".join(_ser_seq(s) for s in alts)


# --------------------------------------------------------- nullability


def _compute_nullable(rules):
    nullable = {n: False for n in rules}

    def atom_nullable(a):
        if a.suffix in ("*", "?") or a.suffix.startswith("{0"):
            return True
        if a.kind == "lit":
            return a.val == ""
        if a.kind == "class":
            return False
        if a.kind == "ref":
            return nullable.get(a.val, False)
        return any(all(atom_nullable(x) for x in s) for s in a.val)

    changed = True
    while changed:
        changed = False
        for n, alts in rules.items():
            v = any(all(atom_nullable(a) for a in s) for s in alts)
            if v and not nullable[n]:
                nullable[n] = True
                changed = True
    return nullable, atom_nullable


def _left_refs(alts, atom_nullable):
    """Rule names reachable at the left edge (through nullable prefixes)."""
    out = set()

    def seq_refs(seq):
        for a in seq:
            if a.kind == "ref":
                out.add(a.val)
            elif a.kind == "group":
                for s in a.val:
                    seq_refs(s)
            if not atom_nullable(a):
                break

    for s in alts:
        seq_refs(s)
    return out


def left_recursive_rules(rules) -> set:
    """Names on a leftmost-reachability cycle."""
    nullable, atom_nullable = _compute_nullable(rules)
    graph = {n: _left_refs(alts, atom_nullable) for n, alts in rules.items()}
    # transitive closure
    closure = {n: set(g) for n, g in graph.items()}
    changed = True
    while changed:
        changed = False
        for n in closure:
            add = set()
            for m in closure[n]:
                add |= closure.get(m, set())
            if not add <= closure[n]:
                closure[n] |= add
                changed = True
    return {n for n in rules if n in closure[n]}


# ------------------------------------------------- left-edge normalization


def _normalize_left(alts, cycle, atom_nullable):
    """Expand alternatives until each either starts with a PLAIN cycle-rule
    ref (no suffix), or its left edge cannot reach a cycle rule."""

    def edge_hits_cycle(seq):
        for a in seq:
            if a.kind == "ref" and a.val in cycle:
                return True
            if a.kind == "group" and any(
                edge_hits_cycle(s) for s in a.val
            ):
                return True
            if not atom_nullable(a):
                return False
        return False

    work = [list(s) for s in alts]
    done = []
    steps = 0
    while work:
        steps += 1
        if steps > 4 * _MAX_ALTS or len(done) + len(work) > _MAX_ALTS:
            raise ValueError("left-recursion normalization explosion")
        seq = work.pop()
        if not seq or not edge_hits_cycle(seq):
            done.append(seq)
            continue
        a, rest = seq[0], seq[1:]
        plain_cycle_ref = a.kind == "ref" and a.val in cycle and a.suffix == ""
        if plain_cycle_ref:
            done.append(seq)
            continue
        if a.kind == "ref" and a.val in cycle:
            # suffixed self-edge ref: peel one occurrence
            bare = Atom("ref", a.val)
            if a.suffix == "?":
                work.append(rest)
                work.append([bare] + rest)
            elif a.suffix == "*":
                work.append(rest)
                star = Atom("ref", a.val, "*")
                work.append([bare, star] + rest)
            elif a.suffix == "+":
                star = Atom("ref", a.val, "*")
                work.append([bare, star] + rest)
            else:  # {m,n} bounds: expand one step
                work.append(rest)
                work.append([bare, a.clone()] + rest)
            continue
        if a.kind == "group":
            if a.suffix == "":
                for galt in a.val:
                    work.append([x.clone() for x in galt] + rest)
            elif a.suffix == "?":
                work.append(rest)
                work.append([Atom("group", a.val)] + rest)
            elif a.suffix in ("*", "+"):
                if a.suffix == "*":
                    work.append(rest)
                star = Atom("group", a.val, "*")
                work.append([Atom("group", a.val), star] + rest)
            else:
                work.append(rest)
                work.append([Atom("group", a.val), a.clone()] + rest)
            continue
        if atom_nullable(a):
            # nullable terminal prefix: split on presence
            work.append(rest)
            forced = a.clone()
            forced.suffix = "+" if a.suffix in ("*", "+") else ""
            work.append([forced] + rest)
            continue
        done.append(seq)  # left edge is a non-nullable terminal
    return done


# ------------------------------------------------------------- elimination


def eliminate_left_recursion(src: str) -> str:
    """Rewrite an EBNF grammar so no rule is left-recursive; returns new
    source. Raises ValueError when the grammar defeats normalization."""
    from scratchpad_tpu_torch.constrained.pda import _split_rules

    toks = _tokenize(src)
    raw = _split_rules(toks)
    rules = {}
    for name, body in raw.items():
        alts, j = _parse_alts(body, 0, stop=())
        if j != len(body):
            raise ValueError(f"trailing tokens in rule {name!r}")
        rules[name] = alts

    cycle = left_recursive_rules(rules)
    if not cycle:
        return src

    _, atom_nullable = _compute_nullable(rules)
    order = [n for n in rules if n in cycle]  # definition order
    for i, name in enumerate(order):
        alts = _normalize_left(rules[name], cycle, atom_nullable)
        # Paull: inline earlier cycle rules' alternatives at the left edge
        changed = True
        while changed:
            changed = False
            nxt = []
            for seq in alts:
                head = seq[0] if seq else None
                if (
                    head is not None
                    and head.kind == "ref"
                    and head.suffix == ""
                    and head.val in order[:i]
                ):
                    for balt in rules[head.val]:
                        nxt.append([x.clone() for x in balt] + seq[1:])
                    changed = True
                else:
                    nxt.append(seq)
            if len(nxt) > _MAX_ALTS:
                raise ValueError("left-recursion substitution explosion")
            alts = nxt
            if changed:
                alts = _normalize_left(alts, cycle, atom_nullable)
        # direct elimination: A ::= A a.. | b..  ->  (b..)(a..)*
        recs, bases = [], []
        for seq in alts:
            if seq and seq[0].kind == "ref" and seq[0].val == name and seq[0].suffix == "":
                tail = seq[1:]
                if tail:  # A -> A alone is vacuous
                    recs.append(tail)
            else:
                bases.append(seq)
        if recs:
            if not bases:
                raise ValueError(
                    f"rule {name!r} has no non-left-recursive alternative"
                )
            star = Atom("group", recs, "*")
            nonempty = [b for b in bases if b]
            if len(nonempty) == len(bases):
                rules[name] = [[Atom("group", bases), star]]
            elif nonempty:
                rules[name] = [[Atom("group", nonempty, "?"), star]]
            else:
                rules[name] = [[star]]
        else:
            rules[name] = alts

    return "\n".join(f"{n} ::= {_ser_alts(a)}" for n, a in rules.items())
