"""Grammar backend: compiled DFAs + per-request token-bitmask state.

The port's copy of ``scratchpad_tpu/constrained/backend.py``. The token
walk runs in the host library ``csrc/fsm.cpp`` (``pda.cpp`` for the
pushdown grammars), built at first use by ``utils/native.build_host``;
``native=False`` takes the Python walk, its plain version, and a native
library that cannot be built raises instead of falling back. ``WALKS``
counts the state masks each walk filled.

Re-creates the reference's grammar-backend surface
(reference: scratchpad/constrained/base_backend.py:65-96,
xgrammar_backend.py:82-100) on the native regex engine:

- compile cache keyed by (kind, value) with background compilation via a
  thread pool (the scheduler polls readiness like the reference's
  futures queue, scheduler.py:1723)
- per-state allowed-token bitmasks are computed lazily and cached on the
  compiled grammar (shared across requests)
- the mask is applied on device inside the sampler
  (sampling/sampler.py apply_vocab_bitmask)
"""

from __future__ import annotations

import collections
import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from scratchpad_tpu_torch.constrained.json_schema import schema_to_regex
from scratchpad_tpu_torch.constrained.regex_fsm import DFA, compile_regex
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("constrained")

# state masks filled, by walk: "fsm native", "fsm python", "pda native",
# "pda python"
WALKS: collections.Counter = collections.Counter()


def single_set_bit(mask: np.ndarray):
    """Token id when EXACTLY one bit is set in the u32 bitmask, else None —
    the jump-forward primitive shared by both grammar cursors."""
    total = int(np.unpackbits(mask.view(np.uint8)).sum())
    if total != 1:
        return None
    word = int(np.argmax(mask != 0))
    bit = int(mask[word]).bit_length() - 1
    return word * 32 + bit


def _load_fsm_native():
    """ctypes handle to the C++ token walk (csrc/fsm.cpp); raises if the
    library cannot be built."""
    import ctypes

    from scratchpad_tpu_torch.utils.native import load_host

    lib = load_host("fsm")

    fn = lib.sptpu_fsm_compute_state
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # trans
        ctypes.c_int32,  # num_classes
        ctypes.POINTER(ctypes.c_int32),  # seqs
        ctypes.POINTER(ctypes.c_int64),  # offsets
        ctypes.c_int64,  # vocab
        ctypes.c_int32,  # state
        ctypes.POINTER(ctypes.c_uint32),  # mask
        ctypes.POINTER(ctypes.c_int32),  # dst
    ]
    fn.restype = None
    return fn


class CompiledGrammar:
    """A DFA plus tokenizer-vocabulary transition/bitmask caches.

    The per-state mask fill walks every vocab token through the DFA — the
    hot path the reference delegates to xgrammar's C++ mask computation
    (reference: scratchpad/constrained/xgrammar_backend.py:82-100). Here it
    runs in the in-repo C++ walk (csrc/fsm.cpp) over a densified
    transition table, or with ``native=False`` in the Python walk.
    """

    def __init__(
        self, dfa: DFA, token_strs: list[Optional[str]], eos_ids: set[int], native: bool = True
    ):
        self.dfa = dfa
        self.token_strs = token_strs
        self.eos_ids = eos_ids
        self.vocab_size = len(token_strs)
        self._lock = threading.Lock()
        # per-state caches
        self._bitmask: dict[int, np.ndarray] = {}
        self._token_dst: dict[int, np.ndarray] = {}
        self._native = _load_fsm_native() if native else None
        if self._native is not None:
            self._densify()

    def _densify(self) -> None:
        """Dense transition table + per-token class-id sequences for C++.

        Classes: one id per explicit alphabet char, plus OTHER (last id)
        for every char outside the pattern's alphabet — matching
        DFA.step's semantics exactly.
        """
        chars = sorted(self.dfa.alphabet)
        cls = {c: i for i, c in enumerate(chars)}
        C = len(chars) + 1  # + OTHER
        S = self.dfa.num_states
        trans = np.full((S, C), -1, np.int32)
        for s, t in enumerate(self.dfa.transitions):
            other = t.get(None, -1)
            trans[s, C - 1] = other
            for c, i in cls.items():
                trans[s, i] = t.get(c, -1)
        seqs: list[int] = []
        offsets = np.zeros(self.vocab_size + 1, np.int64)
        get = cls.get
        OTHER = C - 1
        for tid, s in enumerate(self.token_strs):
            if s:
                seqs.extend(get(c, OTHER) for c in s)
            offsets[tid + 1] = len(seqs)
        self._trans = np.ascontiguousarray(trans)
        self._nclasses = C
        self._seqs = np.asarray(seqs or [0], np.int32)
        self._offsets = offsets

    def _compute_state(self, state: int) -> None:
        words = -(-self.vocab_size // 32)
        mask = np.zeros(words, np.uint32)
        dst = np.full(self.vocab_size, -1, np.int32)
        if self._native is not None:
            import ctypes

            i32p = ctypes.POINTER(ctypes.c_int32)
            self._native(
                self._trans.ctypes.data_as(i32p),
                self._nclasses,
                self._seqs.ctypes.data_as(i32p),
                self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.vocab_size,
                state,
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                dst.ctypes.data_as(i32p),
            )
            WALKS["fsm native"] += 1
        else:
            WALKS["fsm python"] += 1
            walk = self.dfa.walk
            for tid, s in enumerate(self.token_strs):
                if not s:
                    continue
                d = walk(state, s)
                if d >= 0:
                    dst[tid] = d
                    mask[tid >> 5] |= np.uint32(1 << (tid & 31))
        if self.dfa.is_accepting(state):
            for e in self.eos_ids:
                if e < self.vocab_size:
                    mask[e >> 5] |= np.uint32(1 << (e & 31))
        with self._lock:
            self._bitmask[state] = mask
            self._token_dst[state] = dst

    def bitmask_for(self, state: int) -> np.ndarray:
        if state not in self._bitmask:
            self._compute_state(state)
        return self._bitmask[state]

    def next_state(self, state: int, token_id: int) -> int:
        if state not in self._token_dst:
            self._compute_state(state)
        d = int(self._token_dst[state][token_id])
        if d >= 0:
            return d
        if token_id in self.eos_ids:
            return state
        # shouldn't happen when the mask was applied; fail safe
        s = self.token_strs[token_id] or ""
        w = self.dfa.walk(state, s)
        return w if w >= 0 else state


class Grammar:
    """Per-request FSM cursor (xgrammar GrammarMatcher analogue)."""

    def __init__(self, compiled: CompiledGrammar):
        self.compiled = compiled
        self.state = compiled.dfa.initial
        self.finished = False

    def fill_vocab_bitmask(self, mask_row: np.ndarray, vocab_size: int) -> None:
        m = self.compiled.bitmask_for(self.state)
        mask_row[: len(m)] = m

    def accept_token(self, token_id: int) -> None:
        if token_id in self.compiled.eos_ids:
            self.finished = True
            return
        self.state = self.compiled.next_state(self.state, token_id)

    def forced_next_token(self) -> Optional[int]:
        """Token id when the grammar allows exactly ONE continuation — the
        jump-forward primitive (reference: constrained/outlines_jump_forward.py:31).
        Returns None when the choice is free."""
        if self.finished:
            return None
        return single_set_bit(self.compiled.bitmask_for(self.state))

    def is_terminated(self) -> bool:
        return self.finished

    def reset(self) -> None:
        self.state = self.compiled.dfa.initial
        self.finished = False


def _token_strings(tokenizer, vocab_size: int) -> list[Optional[str]]:
    """Decode each vocab id to its surface string."""
    strs: list[Optional[str]] = [None] * vocab_size
    # fast path: HF fast tokenizers expose the vocab directly
    try:
        vocab = tokenizer.get_vocab()
    except Exception:
        vocab = None
    if vocab and hasattr(tokenizer, "convert_tokens_to_string"):
        for tok_s, tid in vocab.items():
            if tid < vocab_size:
                try:
                    strs[tid] = tokenizer.convert_tokens_to_string([tok_s])
                except Exception:
                    strs[tid] = None
        return strs
    for tid in range(vocab_size):
        try:
            strs[tid] = tokenizer.decode([tid])
        except Exception:
            strs[tid] = None
    return strs


class GrammarBackend:
    """Compile cache + thread-pool compilation
    (reference: constrained/base_backend.py:65 get_cached_or_future_value)."""

    def __init__(self, tokenizer, vocab_size: int, native: bool = True):
        self.tokenizer = tokenizer
        self.native = native
        self.vocab_size = vocab_size
        self._token_strs: Optional[list] = None
        self._cache: dict[tuple[str, str], CompiledGrammar] = {}
        self._futures: dict[tuple[str, str], Future] = {}
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._lock = threading.Lock()
        eos = getattr(tokenizer, "eos_token_id", None)
        self.eos_ids = {eos} if eos is not None else set()

    def _tokens(self):
        if self._token_strs is None:
            self._token_strs = _token_strings(self.tokenizer, self.vocab_size)
        return self._token_strs

    def _compile(self, kind: str, value: str) -> CompiledGrammar:
        if kind == "regex":
            pattern = value
        elif kind == "json":
            if value in ("true", "True", ""):
                schema = True
            else:
                schema = json.loads(value)
            if schema is True or schema == {}:
                # unconstrained JSON: exact arbitrary-depth guidance on the
                # pushdown engine (the regex translation bounds nesting)
                from scratchpad_tpu_torch.constrained.pda import (
                    GENERIC_JSON_EBNF,
                    CompiledPDAGrammar,
                )

                return CompiledPDAGrammar(
                    GENERIC_JSON_EBNF, self._tokens(), self.eos_ids, native=self.native
                )
            pattern = schema_to_regex(schema)
        elif kind == "ebnf":
            from scratchpad_tpu_torch.constrained.ebnf import ebnf_to_regex

            # truly recursive grammars run EXACTLY on the pushdown engine
            # (pda.py, the xgrammar-PDA counterpart); non-recursive ones
            # keep the DFA fast path, and left-recursive ones (PDA compile
            # raises) fall back to the DFA's bounded unroll
            from scratchpad_tpu_torch.constrained.pda import (
                CompiledPDAGrammar,
                is_recursive,
            )

            if is_recursive(value):
                try:
                    return CompiledPDAGrammar(
                        value, self._tokens(), self.eos_ids, native=self.native
                    )
                except ValueError:
                    # left recursion: Paull-eliminate (exact, language-
                    # preserving) and retry the PDA before falling back to
                    # the DFA's bounded unroll (constrained/leftrec.py)
                    try:
                        from scratchpad_tpu_torch.constrained.leftrec import (
                            eliminate_left_recursion,
                        )

                        return CompiledPDAGrammar(
                            eliminate_left_recursion(value),
                            self._tokens(),
                            self.eos_ids,
                            native=self.native,
                        )
                    except ValueError:
                        logger.warning(
                            "EBNF left-recursion elimination failed; "
                            "using the DFA bounded unroll"
                        )
            pattern = ebnf_to_regex(value)
        elif kind == "structural_tag":
            # free text + trigger-committed structures as one DFA
            # (reference: constrained/xgrammar_backend.py:204
            # dispatch_structural_tag)
            from scratchpad_tpu_torch.constrained.structural_tag import (
                compile_structural_tag,
            )

            dfa = compile_structural_tag(value)
            return CompiledGrammar(dfa, self._tokens(), self.eos_ids, self.native)
        else:
            raise ValueError(f"unknown grammar kind {kind}")
        dfa = compile_regex(pattern)
        return CompiledGrammar(dfa, self._tokens(), self.eos_ids, self.native)

    def get_grammar(self, kind: str, value: str, block: bool = True) -> Grammar:
        key = (kind, value)
        with self._lock:
            if key in self._cache:
                return self._cursor(self._cache[key])
            fut = self._futures.get(key)
            if fut is None:
                fut = self._pool.submit(self._compile, kind, value)
                self._futures[key] = fut
        compiled = fut.result() if block else None
        if compiled is None:
            raise RuntimeError("non-blocking grammar fetch not ready")
        with self._lock:
            self._cache[key] = compiled
            self._futures.pop(key, None)
        return self._cursor(compiled)

    @staticmethod
    def _cursor(compiled):
        from scratchpad_tpu_torch.constrained.pda import (
            CompiledPDAGrammar,
            PDAGrammar,
        )

        if isinstance(compiled, CompiledPDAGrammar):
            return PDAGrammar(compiled)
        return Grammar(compiled)
