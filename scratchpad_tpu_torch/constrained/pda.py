"""Pushdown-automaton engine for truly recursive EBNF grammars.

The port's copy of ``scratchpad_tpu/constrained/pda.py``.

The DFA engine (ebnf.py) inlines rules and can only approximate recursion
by bounded unrolling. This module is the exact counterpart of xgrammar's
pushdown automata (reference: scratchpad/constrained/xgrammar_backend.py):

- each rule body compiles to its own char-class DFA in which references to
  other rules are CALL edges (a recursive transition network);
- a matcher configuration is (rule, state, stack) where the stack holds
  (return-rule, return-state) frames, hash-consed so config sets dedupe;
- matching tracks a SET of configurations (the grammar may be ambiguous
  between consuming a char directly and entering a sub-rule), with
  epsilon-closure over calls and returns;
- the vocabulary bitmask for a step walks every token string through the
  configuration set (cached per canonical set; the C++ walk in
  csrc/pda.cpp does the walking unless ``native=False`` asks for the
  Python walk).

Left-recursive rules make the call closure grow without consuming input;
they are detected at compile time (depth bound) and raise, directing the
user to the DFA engine's bounded unroll.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from scratchpad_tpu_torch.constrained import ebnf as _ebnf
from scratchpad_tpu_torch.constrained.backend import WALKS
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("pda")
from scratchpad_tpu_torch.constrained.regex_fsm import _CharSet, _Parser

_MAX_STACK = 1024  # frames; also bounds closure growth (left recursion)
_MAX_CONFIGS = 4096


# --------------------------------------------------------------- rule NFAs


class _RuleNFA:
    """Thompson NFA for one rule body; labels are _CharSet, ("call", name),
    or None (epsilon)."""

    def __init__(self):
        self.edges: list[list[tuple[object, int]]] = []

    def new(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, s, label, d) -> None:
        self.edges[s].append((label, d))


def _parse_class(text: str) -> _CharSet:
    p = _Parser(text)
    return p._char_class()


class _BodyParser:
    """Recursive-descent over the EBNF token stream building a _RuleNFA."""

    def __init__(self, toks):
        self.toks = toks
        self.i = 0
        self.nfa = _RuleNFA()

    def parse(self) -> tuple[int, int]:
        s, e = self._alternation()
        if self.i < len(self.toks):
            raise ValueError(f"trailing tokens in EBNF rule at {self.toks[self.i]}")
        return s, e

    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _alternation(self):
        s, e = self.nfa.new(), self.nfa.new()
        while True:
            bs, be = self._concat()
            self.nfa.add(s, None, bs)
            self.nfa.add(be, None, e)
            t = self._peek()
            if t is not None and t.kind == "|":
                self.i += 1
                continue
            break
        return s, e

    def _concat(self):
        s = self.nfa.new()
        e = s
        while True:
            t = self._peek()
            if t is None or t.kind in ("|", ")"):
                break
            bs, be = self._postfix()
            self.nfa.add(e, None, bs)
            e = be
        return s, e

    def _postfix(self):
        s, e = self._atom()
        while True:
            t = self._peek()
            if t is None or t.kind not in ("*", "+", "?", "bound"):
                break
            self.i += 1
            if t.kind == "*":
                ns, ne = self.nfa.new(), self.nfa.new()
                self.nfa.add(ns, None, s)
                self.nfa.add(ns, None, ne)
                self.nfa.add(e, None, s)
                self.nfa.add(e, None, ne)
                s, e = ns, ne
            elif t.kind == "+":
                ne = self.nfa.new()
                self.nfa.add(e, None, s)
                self.nfa.add(e, None, ne)
                e = ne
            elif t.kind == "?":
                self.nfa.add(s, None, e)
            else:  # {m}, {m,}, {m,n}: expand by copying the fragment
                body = t.val[1:-1]
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = None if hi_s.strip() == "" else int(hi_s)
                else:
                    lo = hi = int(body)
                s, e = self._repeat(s, e, lo, hi)
        return s, e

    def _clone(self, s, e):
        """Structure-preserving copy of the fragment reachable from s."""
        mapping = {}
        stack = [s]
        mapping[s] = self.nfa.new()
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for _, d in list(self.nfa.edges[u]):
                if d not in mapping:
                    mapping[d] = self.nfa.new()
                    stack.append(d)
        if e not in mapping:
            mapping[e] = self.nfa.new()
        for u in order:
            for label, d in list(self.nfa.edges[u]):
                self.nfa.add(mapping[u], label, mapping[d])
        return mapping[s], mapping[e]

    def _repeat(self, s, e, lo, hi):
        ns = self.nfa.new()
        cur = ns
        for _ in range(max(lo, 0)):
            cs, ce = self._clone(s, e)
            self.nfa.add(cur, None, cs)
            cur = ce
        if hi is None:  # {m,}: tail star
            cs, ce = self._clone(s, e)
            st, en = self.nfa.new(), self.nfa.new()
            self.nfa.add(st, None, cs)
            self.nfa.add(st, None, en)
            self.nfa.add(ce, None, cs)
            self.nfa.add(ce, None, en)
            self.nfa.add(cur, None, st)
            cur = en
        else:
            for _ in range(hi - lo):
                cs, ce = self._clone(s, e)
                nxt = self.nfa.new()
                self.nfa.add(cur, None, cs)
                self.nfa.add(cur, None, nxt)  # optional copy
                self.nfa.add(ce, None, nxt)
                cur = nxt
        return ns, cur

    def _atom(self):
        t = self._peek()
        if t is None:
            raise ValueError("unexpected end of EBNF rule body")
        self.i += 1
        if t.kind == "lit":
            s = self.nfa.new()
            cur = s
            for ch in t.val:
                nxt = self.nfa.new()
                self.nfa.add(cur, _CharSet(frozenset(ch)), nxt)
                cur = nxt
            return s, cur
        if t.kind == "class":
            s, e = self.nfa.new(), self.nfa.new()
            self.nfa.add(s, _parse_class(t.val), e)
            return s, e
        if t.kind == "name":
            s, e = self.nfa.new(), self.nfa.new()
            self.nfa.add(s, ("call", t.val), e)
            return s, e
        if t.kind == "(":
            s, e = self._alternation()
            t2 = self._peek()
            if t2 is None or t2.kind != ")":
                raise ValueError("unbalanced paren in EBNF rule")
            self.i += 1
            return s, e
        raise ValueError(f"unexpected token {t} in EBNF rule body")


# ---------------------------------------------------------- rule automata


class RuleDFA:
    """Determinized rule body over (char classes + call symbols).

    trans[state] : dict cls_id -> state (cls = explicit char class index;
    the shared OTHER class is the last id). calls[state] : list of
    (rule_name, return_state). accepting : set of states."""

    def __init__(self, trans, calls, accepting, initial):
        self.trans = trans
        self.calls = calls
        self.accepting = accepting
        self.initial = initial


class PDA:
    """Compiled grammar: one RuleDFA per rule + the shared char alphabet."""

    def __init__(self, src: str, root: str = "root"):
        self._frames: list = []
        self._frame_ids: dict = {}
        self._depth: list = []
        toks = _ebnf._tokenize(src)
        rules = _split_rules(toks)
        if root not in rules:
            raise ValueError(f"EBNF grammar has no {root!r} rule")
        self.root = root
        nfas: dict[str, tuple[_RuleNFA, int, int]] = {}
        for name, body in rules.items():
            bp = _BodyParser(body)
            s, e = bp.parse()
            nfas[name] = (bp.nfa, s, e)

        # shared alphabet: every char explicitly mentioned anywhere
        explicit: set[str] = set()
        for nfa, _, _ in nfas.values():
            for edges in nfa.edges:
                for label, _ in edges:
                    if isinstance(label, _CharSet):
                        explicit |= label.chars
        self.alphabet = sorted(explicit)
        self.cls = {c: i for i, c in enumerate(self.alphabet)}
        self.OTHER = len(self.alphabet)

        self.rules: dict[str, RuleDFA] = {
            name: self._determinize(*nfas[name]) for name in nfas
        }
        # compile-time sanity: closing the initial configuration detects
        # left recursion (unbounded call closure) early
        self._closure(((self.root, self.rules[self.root].initial, None),))

    # ---- determinization of one rule NFA (calls = opaque symbols)

    def _determinize(self, nfa: _RuleNFA, start: int, end: int) -> RuleDFA:
        def eclose(states):
            out = set(states)
            st = list(states)
            while st:
                u = st.pop()
                for label, d in nfa.edges[u]:
                    if label is None and d not in out:
                        out.add(d)
                        st.append(d)
            return frozenset(out)

        def move_char(states, cls_id):
            ch = self.alphabet[cls_id] if cls_id < self.OTHER else None
            out = set()
            for u in states:
                for label, d in nfa.edges[u]:
                    if not isinstance(label, _CharSet):
                        continue
                    if ch is None:
                        # OTHER: any char outside the shared alphabet; since
                        # every explicit char is in the alphabet, only
                        # negated classes can match it
                        if label.negated:
                            out.add(d)
                    elif label.matches(ch):
                        out.add(d)
            return out

        init = eclose({start})
        ids = {init: 0}
        order = [init]
        trans: list[dict[int, int]] = []
        calls: list[list[tuple[str, int]]] = []
        accepting: set[int] = set()

        def intern(subset) -> int:
            if subset not in ids:
                ids[subset] = len(order)
                order.append(subset)
            return ids[subset]

        qi = 0
        while qi < len(order):
            cur = order[qi]
            qi += 1
            row: dict[int, int] = {}
            for cid in range(self.OTHER + 1):
                nxt = move_char(cur, cid)
                if nxt:
                    row[cid] = intern(eclose(nxt))
            cl: list[tuple[str, int]] = []
            seen = set()
            for u in cur:
                for label, d in nfa.edges[u]:
                    if isinstance(label, tuple) and label[0] == "call":
                        key = (label[1], intern(eclose({d})))
                        if key not in seen:
                            seen.add(key)
                            cl.append(key)
            trans.append(row)
            calls.append(cl)
            if end in cur:
                accepting.add(qi - 1)
        return RuleDFA(trans, calls, accepting, 0)

    # ------------------------------------------------------------- matching
    # stack nodes are hash-consed: None (empty) or an int id into _frames

    def _intern_frame(self, rule, ret_state, parent):
        key = (rule, ret_state, parent)
        f = self._frame_ids.get(key)
        if f is None:
            f = len(self._frames)
            self._frames.append(key)
            self._frame_ids[key] = f
            depth = 1 + (self._depth[parent] if parent is not None else 0)
            self._depth.append(depth)
        return f

    def _closure(self, configs):
        """Epsilon-closure over calls and returns. Config = (rule, state,
        stack_frame_id | None)."""
        out = set()
        stack = list(configs)
        seen = set(configs)
        while stack:
            rule, state, frame = stack.pop()
            out.add((rule, state, frame))
            dfa = self.rules[rule]
            # calls
            for callee, ret_state in dfa.calls[state]:
                parent_depth = self._depth[frame] if frame is not None else 0
                if parent_depth >= _MAX_STACK:
                    raise ValueError(
                        "EBNF grammar call depth exceeded (left-recursive "
                        "rule?) — use the DFA engine's bounded unroll"
                    )
                nf = self._intern_frame(rule, ret_state, frame)
                cfg = (callee, self.rules[callee].initial, nf)
                if cfg not in seen:
                    seen.add(cfg)
                    stack.append(cfg)
            # returns
            if state in dfa.accepting and frame is not None:
                r_rule, r_state, parent = self._frames[frame]
                cfg = (r_rule, r_state, parent)
                if cfg not in seen:
                    seen.add(cfg)
                    stack.append(cfg)
            if len(seen) > _MAX_CONFIGS:
                raise ValueError("EBNF configuration explosion")
        return frozenset(out)

    def initial_configs(self):
        return self._closure(
            ((self.root, self.rules[self.root].initial, None),)
        )

    def step(self, configs, ch: str):
        cid = self.cls.get(ch, self.OTHER)
        nxt = set()
        for rule, state, frame in configs:
            d = self.rules[rule].trans[state].get(cid)
            if d is not None:
                nxt.add((rule, d, frame))
        if not nxt:
            return None
        return self._closure(nxt)

    def walk(self, configs, s: str):
        for ch in s:
            configs = self.step(configs, ch)
            if configs is None:
                return None
        return configs

    def accepts(self, configs) -> bool:
        return any(
            rule == self.root
            and frame is None
            and state in self.rules[rule].accepting
            for rule, state, frame in configs
        )


def _split_rules(toks):
    rules = {}
    i = 0
    while i < len(toks):
        if (
            i + 1 < len(toks)
            and toks[i].kind == "name"
            and toks[i + 1].kind == "def"
        ):
            name = toks[i].val
            i += 2
            body = []
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
    return rules


def is_recursive(src: str, root: str = "root") -> bool:
    """True when any rule reachable from root (transitively) references
    itself."""
    toks = _ebnf._tokenize(src)
    rules = _split_rules(toks)
    refs = {
        name: {t.val for t in body if t.kind == "name"}
        for name, body in rules.items()
    }
    acyclic: set[str] = set()  # memo: rules proven recursion-free
    stack: list[str] = []

    def dfs(name: str) -> bool:
        if name not in rules or name in acyclic:
            return False
        if name in stack:
            return True
        stack.append(name)
        try:
            if any(dfs(r) for r in refs[name]):
                return True
        finally:
            stack.pop()
        acyclic.add(name)
        return False

    return dfs(root)



# ------------------------------------------------------------ native walk


def _load_pda_native():
    """ctypes handles to the C++ PDA mask walk (csrc/pda.cpp); raises if
    the library cannot be built."""
    import ctypes

    from scratchpad_tpu_torch.utils.native import load_host

    lib = load_host("pda")

    fn = lib.sptpu_pda_fill_mask
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [
        i32p,  # trans
        ctypes.c_int32,  # C
        ctypes.POINTER(ctypes.c_uint8),  # accepting
        ctypes.POINTER(ctypes.c_int64),  # call_off
        i32p,  # call_pairs
        i32p,  # seqs
        ctypes.POINTER(ctypes.c_int64),  # offsets
        ctypes.c_int64,  # vocab
        i32p,  # cfg_states
        i32p,  # cfg_stack_off
        i32p,  # cfg_stacks
        ctypes.c_int32,  # n_cfg
        ctypes.POINTER(ctypes.c_uint32),  # mask
        i32p,  # overflow_ids
        ctypes.c_int32,  # max_overflow
        i32p,  # n_overflow
    ]
    fn.restype = None
    cl = lib.sptpu_pda_classify
    cl.argtypes = [
        i32p,  # trans
        ctypes.c_int32,  # C
        ctypes.POINTER(ctypes.c_uint8),  # accepting
        ctypes.POINTER(ctypes.c_int64),  # call_off
        i32p,  # call_pairs
        i32p,  # seqs
        ctypes.POINTER(ctypes.c_int64),  # offsets
        ctypes.c_int64,  # vocab
        i32p,  # states
        ctypes.c_int32,  # n_states
        ctypes.POINTER(ctypes.c_uint32),  # mask
        i32p,  # ctx_ids
        ctypes.c_int32,  # max_ctx
        i32p,  # n_ctx
    ]
    cl.restype = None
    return (fn, cl)


# ------------------------------------------------- grammar-backend surface


class CompiledPDAGrammar:
    """Duck-types constrained.backend.CompiledGrammar for recursive EBNF."""

    def __init__(self, src: str, token_strs, eos_ids: set[int], root="root", native: bool = True):
        self.pda = PDA(src, root)
        self.token_strs = token_strs
        self.eos_ids = eos_ids
        self.vocab_size = len(token_strs)
        self._mask_cache: dict = {}
        self._lock = threading.Lock()
        self._native, self._native_classify = _load_pda_native() if native else (None, None)
        self._ci_cache: dict = {}
        if self._native is not None:
            self._flatten()

    def _flatten(self) -> None:
        """Global tables for the C++ walker: every rule DFA in one dense
        [n_states, C] transition table, acceptance flags, and a call CSR of
        (callee_init_global, return_global) pairs."""
        pda = self.pda
        C = pda.OTHER + 1
        names = sorted(pda.rules)
        off: dict[str, int] = {}
        n = 0
        for name in names:
            off[name] = n
            n += len(pda.rules[name].trans)
        self._off = off
        trans = np.full((n, C), -1, np.int32)
        accepting = np.zeros(n, np.uint8)
        call_off = np.zeros(n + 1, np.int64)
        pairs: list[int] = []
        for name in names:
            dfa = pda.rules[name]
            o = off[name]
            for s_i, row in enumerate(dfa.trans):
                for cid, d in row.items():
                    trans[o + s_i, cid] = o + d
            for s_i in dfa.accepting:
                accepting[o + s_i] = 1
        for name in names:
            dfa = pda.rules[name]
            o = off[name]
            for s_i in range(len(dfa.trans)):
                for callee, ret in dfa.calls[s_i]:
                    pairs.append(off[callee] + pda.rules[callee].initial)
                    pairs.append(o + ret)
                call_off[o + s_i + 1] = len(pairs) // 2
        self._trans = np.ascontiguousarray(trans)
        self._C = C
        self._accepting = accepting
        self._call_off = call_off
        self._call_pairs = np.asarray(pairs or [0, 0], np.int32)
        seqs: list[int] = []
        offsets = np.zeros(self.vocab_size + 1, np.int64)
        get = pda.cls.get
        OTHER = pda.OTHER
        for tid, s in enumerate(self.token_strs):
            if s:
                seqs.extend(get(c, OTHER) for c in s)
            offsets[tid + 1] = len(seqs)
        self._seqs = np.asarray(seqs or [0], np.int32)
        self._offsets = offsets

    def _native_mask(self, configs) -> Optional[np.ndarray]:
        """C++ mask fill; overflowed tokens re-walk in Python."""
        import ctypes

        pda = self.pda
        cfgs = sorted(
            configs,
            key=lambda c: (c[0], c[1], -1 if c[2] is None else c[2]),
        )
        states = np.zeros(len(cfgs), np.int32)
        stack_off = np.zeros(len(cfgs) + 1, np.int32)
        stacks: list[int] = []
        for i, (rule, state, frame) in enumerate(cfgs):
            states[i] = self._off[rule] + state
            chain: list[int] = []
            f = frame
            while f is not None:
                r_rule, r_state, parent = pda._frames[f]
                chain.append(self._off[r_rule] + r_state)  # innermost first
                f = parent
            stacks.extend(reversed(chain))  # outermost first
            stack_off[i + 1] = len(stacks)
        words = -(-self.vocab_size // 32)
        mask = np.zeros(words, np.uint32)
        MAXOV = 512
        overflow = np.zeros(MAXOV, np.int32)
        n_ov = np.zeros(1, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._native(
            self._trans.ctypes.data_as(i32p),
            self._C,
            self._accepting.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._call_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._call_pairs.ctypes.data_as(i32p),
            self._seqs.ctypes.data_as(i32p),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.vocab_size,
            states.ctypes.data_as(i32p),
            stack_off.ctypes.data_as(i32p),
            (np.asarray(stacks or [0], np.int32)).ctypes.data_as(i32p),
            len(cfgs),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            overflow.ctypes.data_as(i32p),
            MAXOV,
            n_ov.ctypes.data_as(i32p),
        )
        if int(n_ov[0]) >= MAXOV:
            # the overflow list saturated (e.g. the config set exceeds the
            # kernel's budget so every token overflows) — tokens past the
            # cap would stay wrongly masked off; do the exact walk instead
            return None
        for tid in overflow[: int(n_ov[0])]:
            s = self.token_strs[int(tid)]
            if s and pda.walk(configs, s) is not None:
                mask[tid >> 5] |= np.uint32(1 << (int(tid) & 31))
        return mask

    _CTX_OVERFLOW = "ctx-overflow"  # cached negative-classification marker

    def _classify(self, proj):
        """(CI-accepted mask, ctx-dependent token ids) for a stack-agnostic
        state projection; None when the ctx list overflows."""
        import ctypes

        hit = self._ci_cache.get(proj)
        if hit is not None:
            return None if hit == self._CTX_OVERFLOW else hit
        states = np.asarray(
            sorted(self._off[rule] + st for rule, st in proj), np.int32
        )
        words = -(-self.vocab_size // 32)
        mask = np.zeros(words, np.uint32)
        MAXCTX = 2048
        ctx = np.zeros(MAXCTX, np.int32)
        n_ctx = np.zeros(1, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._native_classify(
            self._trans.ctypes.data_as(i32p),
            self._C,
            self._accepting.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._call_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._call_pairs.ctypes.data_as(i32p),
            self._seqs.ctypes.data_as(i32p),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.vocab_size,
            states.ctypes.data_as(i32p),
            len(states),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctx.ctypes.data_as(i32p),
            MAXCTX,
            n_ctx.ctypes.data_as(i32p),
        )
        if int(n_ctx[0]) > MAXCTX:
            with self._lock:
                self._ci_cache[proj] = self._CTX_OVERFLOW
            return None
        else:
            ctx_ids = ctx[: int(n_ctx[0])].copy()
            # compact sub-vocabulary of the ctx-dependent tokens so their
            # exact re-walks also run in the native kernel
            lens = (
                self._offsets[ctx_ids + 1] - self._offsets[ctx_ids]
            ).astype(np.int64)
            sub_off = np.zeros(len(ctx_ids) + 1, np.int64)
            np.cumsum(lens, out=sub_off[1:])
            sub_seqs = np.empty(int(sub_off[-1]), np.int32)
            for i, t in enumerate(ctx_ids):
                a, b = self._offsets[t], self._offsets[t + 1]
                sub_seqs[sub_off[i] : sub_off[i + 1]] = self._seqs[a:b]
            out = (mask, ctx_ids, sub_seqs, sub_off)
        with self._lock:
            self._ci_cache[proj] = out
        return out

    def _native_mask_subset(self, configs, ctx_ids, sub_seqs, sub_off):
        """Exact native walk of ONLY the ctx-dependent tokens; returns a
        bool array aligned with ctx_ids (None on overflow)."""
        import ctypes

        pda = self.pda
        cfgs = sorted(
            configs,
            key=lambda c: (c[0], c[1], -1 if c[2] is None else c[2]),
        )
        states = np.zeros(len(cfgs), np.int32)
        stack_off = np.zeros(len(cfgs) + 1, np.int32)
        stacks: list[int] = []
        for i, (rule, state, frame) in enumerate(cfgs):
            states[i] = self._off[rule] + state
            chain: list[int] = []
            f = frame
            while f is not None:
                r_rule, r_state, parent = pda._frames[f]
                chain.append(self._off[r_rule] + r_state)
                f = parent
            stacks.extend(reversed(chain))
            stack_off[i + 1] = len(stacks)
        n = len(ctx_ids)
        words = -(-n // 32)
        mask = np.zeros(max(words, 1), np.uint32)
        MAXOV = 512
        overflow = np.zeros(MAXOV, np.int32)
        n_ov = np.zeros(1, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._native(
            self._trans.ctypes.data_as(i32p),
            self._C,
            self._accepting.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._call_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._call_pairs.ctypes.data_as(i32p),
            sub_seqs.ctypes.data_as(i32p),
            sub_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            states.ctypes.data_as(i32p),
            stack_off.ctypes.data_as(i32p),
            (np.asarray(stacks or [0], np.int32)).ctypes.data_as(i32p),
            len(cfgs),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            overflow.ctypes.data_as(i32p),
            MAXOV,
            n_ov.ctypes.data_as(i32p),
        )
        if int(n_ov[0]) >= MAXOV:
            return None
        ok = (mask[np.arange(n) >> 5] >> (np.arange(n) & 31)) & 1
        for j in overflow[: int(n_ov[0])]:
            s2 = self.token_strs[int(ctx_ids[int(j)])]
            ok[int(j)] = bool(
                s2 and self.pda.walk(configs, s2) is not None
            )
        return ok.astype(bool)

    def mask_and_dsts(self, configs):
        """(bitmask words, {token_id: next_configs}) for a config set."""
        key = configs
        with self._lock:
            if len(self._mask_cache) > 2048:
                self._mask_cache.clear()  # coarse bound; ~16 KB/entry
            hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        dst: dict[int, object] = {}
        mask = None
        if self._native is not None:
            # adaptive masks: most tokens are context-INDEPENDENT for a
            # given (rule, state) projection — their bits cache across all
            # stacks at that projection; only tokens that pop past the
            # current frames (e.g. runs of closers) re-walk exactly
            proj = frozenset((rule, st) for rule, st, _ in configs)
            ci = self._classify(proj)
            if ci is not None:
                ci_mask, ctx_ids, sub_seqs, sub_off = ci
                mask = ci_mask.copy()
                if len(ctx_ids):
                    ok = self._native_mask_subset(
                        configs, ctx_ids, sub_seqs, sub_off
                    )
                    if ok is None:
                        mask = self._native_mask(configs)
                    else:
                        for tid in ctx_ids[ok]:
                            mask[tid >> 5] |= np.uint32(1 << (int(tid) & 31))
            else:
                mask = self._native_mask(configs)
        WALKS["pda python" if mask is None else "pda native"] += 1
        if mask is None:
            words = -(-self.vocab_size // 32)
            mask = np.zeros(words, np.uint32)
            for tid, s in enumerate(self.token_strs):
                if not s:
                    continue
                nxt = self.pda.walk(configs, s)
                if nxt is not None:
                    dst[tid] = nxt
                    mask[tid >> 5] |= np.uint32(1 << (tid & 31))
        if self.pda.accepts(configs):
            for e in self.eos_ids:
                if e < self.vocab_size:
                    mask[e >> 5] |= np.uint32(1 << (e & 31))
        with self._lock:
            self._mask_cache[key] = (mask, dst)
        return mask, dst


class PDAGrammar:
    """Per-request cursor (duck-types constrained.backend.Grammar).

    Runtime blowups (config explosion / stack-depth bound on adversarial
    generations) degrade the ONE request to unconstrained generation
    instead of raising into the scheduler step loop."""

    def __init__(self, compiled: CompiledPDAGrammar):
        self.compiled = compiled
        self.configs = compiled.pda.initial_configs()
        self.finished = False

    def fill_vocab_bitmask(self, mask_row: np.ndarray, vocab_size: int) -> None:
        if self.finished:
            return
        try:
            m, _ = self.compiled.mask_and_dsts(self.configs)
        except ValueError as e:
            logger.warning("PDA grammar degraded to unconstrained: %s", e)
            self.finished = True
            mask_row[:] = np.uint32(0xFFFFFFFF)
            return
        mask_row[: len(m)] = m

    def accept_token(self, token_id: int) -> None:
        if self.finished or token_id in self.compiled.eos_ids:
            self.finished = True
            return
        try:
            _, dst = self.compiled.mask_and_dsts(self.configs)
            nxt = dst.get(token_id)
            if nxt is None:
                s = self.compiled.token_strs[token_id] or ""
                nxt = self.compiled.pda.walk(self.configs, s)
        except ValueError as e:
            logger.warning("PDA grammar degraded to unconstrained: %s", e)
            self.finished = True
            return
        if nxt is not None:
            self.configs = nxt

    def forced_next_token(self) -> Optional[int]:
        if self.finished:
            return None
        from scratchpad_tpu_torch.constrained.backend import single_set_bit

        m, _ = self.compiled.mask_and_dsts(self.configs)
        return single_set_bit(m)

    def is_terminated(self) -> bool:
        return self.finished

    def reset(self) -> None:
        self.configs = self.compiled.pda.initial_configs()
        self.finished = False


# canonical full-JSON grammar (any nesting depth; used for unconstrained
# response_format=json instead of the depth-bounded regex translation)
GENERIC_JSON_EBNF = r'''
root ::= ws value ws
value ::= object | array | string | number | "true" | "false" | "null"
object ::= "{" ws ( member ( ws "," ws member )* )? ws "}"
member ::= string ws ":" ws value
array ::= "[" ws ( value ( ws "," ws value )* )? ws "]"
string ::= "\"" char* "\""
char ::= [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" hex hex hex hex)
hex ::= [0-9a-fA-F]
number ::= "-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? (("e" | "E") ("+" | "-")? [0-9]+)?
ws ::= [ \t\n]*
'''
