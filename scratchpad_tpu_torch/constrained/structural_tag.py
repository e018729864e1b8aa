"""structural_tag response format -> one character DFA.

The port's copy of ``scratchpad_tpu/constrained/structural_tag.py``.

The OpenAI extension the reference supports via xgrammar's
compile_structural_tag (reference: scratchpad/constrained/
xgrammar_backend.py:204-220, protocol.py:39-42): output is free text
until a *trigger* string appears; from the trigger on, the text must
complete one of the structures whose ``begin`` starts with that trigger
(the begin literal, then content matching the structure's JSON schema,
then the ``end`` literal), after which free text resumes. Repeatable.

Construction: instead of a pushdown grammar we build ONE
character-level DFA by direct product —

  free text  = an Aho-Corasick automaton over the triggers (every state
               accepting; chars outside every trigger loop at the root)
  trigger t  = AC terminal states jump into a continuation DFA compiled
               from  alt_i( begin_i[len(t):]  schema_i  end_i )
  end        = continuation accepting states merge back into the AC root

so the result rides the existing CompiledGrammar machinery: cached
per-state vocab bitmasks, the C++ token-walk kernel (csrc/fsm.cpp), and
jump-forward, with no new runtime code.
"""

from __future__ import annotations

import json
from typing import Optional

from scratchpad_tpu_torch.constrained.json_schema import schema_to_regex
from scratchpad_tpu_torch.constrained.regex_fsm import DFA, compile_regex

_META = set("\\^$.|?*+()[]{}")


def _escape(s: str) -> str:
    return "".join(("\\" + c) if c in _META else c for c in s)


def _ac_states(triggers: list[str]) -> list[str]:
    """All proper prefixes of the triggers ('' = root), dedup, stable."""
    seen: list[str] = [""]
    for t in triggers:
        for i in range(1, len(t)):
            p = t[:i]
            if p not in seen:
                seen.append(p)
    return seen


def _ac_next(prefixes: list[str], state: str, c: str, triggers: list[str]):
    """Longest suffix of state+c that is a trigger (-> ('hit', t)) or a
    proper prefix of one (-> ('pre', p))."""
    s = state + c
    for start in range(len(s)):
        suf = s[start:]
        if suf in triggers:
            return "hit", suf
        if suf in prefixes:
            return "pre", suf
    return "pre", ""


def build_structural_tag_dfa(tag: dict) -> DFA:
    """tag = {"structures": [{"begin", "schema", "end"}, ...],
    "triggers": [str, ...]} (reference: protocol.py:39 StructuralTag...)."""
    structures = tag.get("structures") or []
    triggers = [t for t in (tag.get("triggers") or []) if t]
    if not structures:
        raise ValueError("structural_tag needs at least one structure")
    if not triggers:
        # xgrammar requires triggers; default each begin to its own trigger
        triggers = [s["begin"] for s in structures if s.get("begin")]
    # continuation regex per trigger: any structure whose begin extends it
    cont_dfa: dict[str, DFA] = {}
    for t in triggers:
        alts = []
        for s in structures:
            begin = s.get("begin", "")
            if not begin.startswith(t):
                continue
            schema = s.get("schema")
            body = schema_to_regex(schema if schema is not None else True)
            alts.append(_escape(begin[len(t):]) + body + _escape(s.get("end", "")))
        if not alts:
            raise ValueError(f"trigger {t!r} matches no structure begin")
        cont_dfa[t] = compile_regex("|".join(f"(?:{a})" for a in alts))

    prefixes = _ac_states(triggers)
    n_free = len(prefixes)
    pref_id = {p: i for i, p in enumerate(prefixes)}

    # global state layout: [free AC states][cont DFA of trigger 0][...]
    offsets: dict[str, int] = {}
    total = n_free
    for t in triggers:
        offsets[t] = total
        total += cont_dfa[t].num_states

    alphabet: set[str] = set()
    for t in triggers:
        alphabet |= set(t)
        alphabet |= set(cont_dfa[t].alphabet)

    transitions: list[dict[Optional[str], int]] = [dict() for _ in range(total)]
    accepting: set[int] = set()

    def free_target(state_prefix: str, c: str) -> int:
        kind, nxt = _ac_next(prefixes, state_prefix, c, triggers)
        if kind == "hit":
            d = cont_dfa[nxt]
            # a zero-length begin-remainder + empty-match schema is not a
            # thing (schema regex never matches ''), so initial is safe
            return offsets[nxt] + d.initial
        return pref_id[nxt]

    root_edges: dict[Optional[str], int] = {}
    for p in prefixes:
        i = pref_id[p]
        accepting.add(i)  # free text may end anywhere
        for c in alphabet:
            transitions[i][c] = free_target(p, c)
        transitions[i][None] = pref_id[""]  # chars outside alphabet -> root
    root_edges = dict(transitions[pref_id[""]])

    for t in triggers:
        d = cont_dfa[t]
        off = offsets[t]
        for s in range(d.num_states):
            gi = off + s
            if d.is_accepting(s):
                # structure complete: free text resumes — this state
                # behaves like the AC root for any char the structure
                # itself does not consume further
                accepting.add(gi)
                for c, dst in root_edges.items():
                    transitions[gi][c] = dst
            for c in alphabet:
                nxt = d.step(s, c)
                if nxt >= 0:
                    transitions[gi][c] = off + nxt
            oth = d.transitions[s].get(None, -1)
            if oth >= 0:
                transitions[gi][None] = off + oth
            elif d.is_accepting(s):
                transitions[gi][None] = root_edges.get(None, pref_id[""])

    return DFA(
        transitions=transitions,
        initial=pref_id[""],
        accepting=frozenset(accepting),
        alphabet=frozenset(alphabet),
    )


def compile_structural_tag(value: str) -> DFA:
    """value = JSON-encoded structural_tag request payload."""
    return build_structural_tag_dfa(json.loads(value))
