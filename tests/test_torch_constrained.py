"""The port's constrained decoding against the JAX package's, on the CPU.

- The copied modules (``constrained/regex_fsm``, ``json_schema``, ``ebnf``,
  ``leftrec``, ``pda``, ``structural_tag``) on the same inputs as their
  JAX counterparts: equal DFA tables and matches, equal regex strings from
  schemas and non-recursive grammars, equal left-recursion rewrites.
- ``fill_vocab_bitmask`` bit for bit along token walks of regex, JSON
  schema, generic-JSON (pushdown), EBNF (DFA, pushdown, left-recursive) and
  structural-tag grammars: the JAX backend's cursor, the port's native walk
  (``csrc/fsm.cpp``, ``csrc/pda.cpp``) and the port's Python walk, with
  the same forced tokens (jump-forward) at every step.
- ``apply_vocab_bitmask`` against the JAX sampler's, bit-equal in f32.
- A native library that cannot be built raises.
- Greedy constrained generation of the port's ``tiny-debug`` engine
  against the JAX engine on one pytree (``params_from_jax``): equal ids;
  a literal-heavy grammar takes fewer scheduler steps than tokens
  (jump-forward); one batch of grammar and free requests under
  ``enable_overlap=True`` never sends a grammar mask down the pipelined
  path and gives the JAX engine's ids.

Tokens are characters (the port's ``tokenizer/chars.py``: id = ord(char)
+ 1, eos 0), as in ``tests/test_constrained.py``: the repository holds no
BPE vocabulary.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.constrained import ebnf as jax_ebnf
from scratchpad_tpu.constrained import json_schema as jax_json_schema
from scratchpad_tpu.constrained import leftrec as jax_leftrec
from scratchpad_tpu.constrained import pda as jax_pda
from scratchpad_tpu.constrained import regex_fsm as jax_regex_fsm
from scratchpad_tpu.constrained import structural_tag as jax_structural_tag
from scratchpad_tpu.constrained.backend import GrammarBackend as JaxGrammarBackend
from scratchpad_tpu.sampling.sampler import apply_vocab_bitmask as jax_apply_vocab_bitmask
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.constrained import GrammarBackend, backend, ebnf, json_schema, leftrec, pda
from scratchpad_tpu_torch.constrained import regex_fsm, structural_tag
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.sampler import apply_vocab_bitmask
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.tokenizer import load_tokenizer
from scratchpad_tpu_torch.tokenizer.chars import CharTokenizer
from scratchpad_tpu_torch.utils import native
import torch_threads  # noqa: F401  (one torch thread a test process)


V = 300  # tokens 257.. decode to nothing: never allowed
PATTERNS = [r"(yes|no)!", r"\d{2,4}", r"[^0-9]+x?", r"\w+@\w+\.(com|org)", r"a{2,}b*", r"(ab|cd)+"]
SCHEMAS = [
    {"type": "integer"},
    {"enum": ["red", "green", 3]},
    {"type": "object", "properties": {"name": {"type": "string", "maxLength": 5},
                                      "age": {"type": "integer"}}, "required": ["name", "age"]},
    {"type": "array", "items": {"type": "boolean"}, "maxItems": 3},
    {"anyOf": [{"type": "null"}, {"type": "number"}]},
    True,
]
EBNF_FLAT = 'root ::= cmd " " arg\ncmd ::= "GET" | "PUT" | "DEL"\narg ::= [a-z]+ [0-9]?'
EBNF_RECURSIVE = 'root ::= "(" root ")" | "x" | "[" list "]"\nlist ::= root ("," root)*'
EBNF_LEFT = 'root ::= expr\nexpr ::= expr "+" term | term\nterm ::= [0-9]'
TAG = {"structures": [{"begin": "<f=a>", "schema": {"type": "object", "properties": {
    "x": {"type": "boolean"}}, "required": ["x"]}, "end": "</f>"}], "triggers": ["<f="]}
# (grammar kind, value, a text of the language to walk)
WALKS = {
    "regex": ("regex", r"(yes|no): [a-c]+!", "no: abcab!"),
    "json": ("json", json.dumps(SCHEMAS[2]), '{"name": "bob", "age": -12}'),
    "generic json": ("json", "true", '{"a": [1, {"b": null}], "c": "x\\"y"}'),
    "ebnf": ("ebnf", EBNF_FLAT, "PUT abc7"),
    "ebnf recursive": ("ebnf", EBNF_RECURSIVE, "([x,(x),[x]])"),
    "ebnf left-recursive": ("ebnf", EBNF_LEFT, "1+2+3"),
    "structural tag": ("structural_tag", json.dumps(TAG), 'hi <f=a>{"x": true}</f> ok'),
}


def _tables(dfa):
    return dfa.transitions, dfa.initial, dfa.accepting, dfa.alphabet


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_dfa_matches_jax(pattern):
    a, b = regex_fsm.compile_regex(pattern), jax_regex_fsm.compile_regex(pattern)
    assert _tables(a) == _tables(b)
    for s in ("yes!", "12345", "abx", "a_1@b.com", "aab", "abcd", "", "no"):
        assert a.walk(a.initial, s) == b.walk(b.initial, s)


@pytest.mark.parametrize("schema", SCHEMAS, ids=[str(i) for i in range(len(SCHEMAS))])
def test_schema_to_regex_matches_jax(schema):
    assert json_schema.schema_to_regex(schema) == jax_json_schema.schema_to_regex(schema)


def test_grammars_compile_as_in_jax():
    """EBNF to regex (non-recursive), recursion detection, Paull's rewrite
    and the structural tag's product DFA: the JAX modules' outputs."""
    assert ebnf.ebnf_to_regex(EBNF_FLAT) == jax_ebnf.ebnf_to_regex(EBNF_FLAT)
    for src in (EBNF_FLAT, EBNF_RECURSIVE, EBNF_LEFT):
        assert pda.is_recursive(src) == jax_pda.is_recursive(src)
    assert leftrec.eliminate_left_recursion(EBNF_LEFT) == jax_leftrec.eliminate_left_recursion(EBNF_LEFT)
    tag = json.dumps(TAG)
    assert _tables(structural_tag.compile_structural_tag(tag)) == _tables(
        jax_structural_tag.compile_structural_tag(tag))


@pytest.mark.parametrize("walk", list(WALKS))
def test_bitmask_walks_match_jax(walk):
    """Along the walk of a text of the grammar's language: the masks of the
    JAX cursor, the port's native walk and its Python walk bit for bit, and
    the forced token; the text's token is allowed at each step and eos at
    the end."""
    kind, value, text = WALKS[walk]
    tok = CharTokenizer()
    cursors = [JaxGrammarBackend(tok, V).get_grammar(kind, value),
               GrammarBackend(tok, V).get_grammar(kind, value),
               GrammarBackend(tok, V, native=False).get_grammar(kind, value)]
    assert type(cursors[1]).__name__ == type(cursors[0]).__name__
    assert cursors[1].compiled._native is not None and cursors[2].compiled._native is None
    words = -(-V // 32)
    for t in tok.encode(text) + [tok.eos_token_id]:
        masks = []
        for c in cursors:
            m = np.zeros(words, np.uint32)
            c.fill_vocab_bitmask(m, V)
            masks.append(m)
        np.testing.assert_array_equal(masks[1], masks[0])
        np.testing.assert_array_equal(masks[2], masks[0])
        assert (masks[0][t >> 5] >> (t & 31)) & 1, (walk, t)
        forced = [c.forced_next_token() for c in cursors]
        assert forced[1] == forced[2] == forced[0]
        for c in cursors:
            c.accept_token(t)
    assert all(c.is_terminated() for c in cursors)


def test_native_walks_are_counted():
    backend.WALKS.clear()
    tok = CharTokenizer()
    for be in (GrammarBackend(tok, V), GrammarBackend(tok, V, native=False)):
        for kind, value, _ in (WALKS["regex"], WALKS["ebnf recursive"]):
            be.get_grammar(kind, value).fill_vocab_bitmask(np.zeros(-(-V // 32), np.uint32), V)
    assert dict(backend.WALKS) == {"fsm native": 1, "pda native": 1, "fsm python": 1, "pda python": 1}


def test_a_native_build_that_fails_raises(tmp_path, monkeypatch):
    """No quiet fallback: a grammar that asks for the native walk raises when
    the host library cannot be built."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        GrammarBackend(CharTokenizer(), V).get_grammar("regex", "a+")
    with pytest.raises(RuntimeError):
        native.load_host("pda")
    assert GrammarBackend(CharTokenizer(), V, native=False).get_grammar("regex", "a+") is not None


@pytest.mark.parametrize("V", [1000, 1024])
def test_apply_vocab_bitmask_matches_jax(V):
    """Random logits and masks, a row that allows all, one that allows only
    the last token: bit-equal f32 outputs, u32 or int32 words alike."""
    rng = np.random.default_rng(V)
    B, W = 4, -(-V // 32)
    logits = rng.normal(size=(B, V)).astype(np.float32) * 10
    mask = rng.integers(0, 2**32, size=(B, W), dtype=np.uint64).astype(np.uint32)
    mask[1] = 0xFFFFFFFF
    mask[2] = 0
    mask[2, (V - 1) // 32] = np.uint32(1 << ((V - 1) % 32))
    ref = np.asarray(jax_apply_vocab_bitmask(jnp.asarray(logits), jnp.asarray(mask)))
    for words in (torch.from_numpy(mask), torch.from_numpy(mask.view(np.int32))):
        out = apply_vocab_bitmask(torch.from_numpy(logits), words).numpy()
        np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert np.sum(ref[2] > -1e29) == 1 and np.all(ref[1] == logits[1])


# ------------------------------------------------------------------ engines

ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4,
            max_total_tokens=2048, decode_window_size=4)
# requests whose greedy output ends inside max new tokens (finite languages,
# or a bias that steers the pick to a short word); (sampling kwargs, max new)
GRAMMAR_REQUESTS = [
    (dict(regex=r"(yes|no)!"), 8),
    (dict(json_schema=json.dumps(SCHEMAS[2]).replace('"integer"', '"boolean"')), 64),
    (dict(ebnf='root ::= cmd " " arg\ncmd ::= "GET" | "PUT"\narg ::= [a-z] [a-z]? [0-9]'), 12),
    (dict(ebnf='root ::= "(" root ")" | "x"', logit_bias={ord("x") + 1: 100.0}), 8),
    (dict(structural_tag=json.dumps({"structures": [{"begin": "<", "schema": {"enum": ["a", "b"]},
                                                     "end": ">"}], "triggers": ["<"]}),
          logit_bias={ord("<") + 1: 100.0}), 10),
    (dict(regex=r"The answer is (yes|no)\. Done!"), 40),
]
PROMPT = CharTokenizer().encode("Q: answer in the format asked. A: ")


def _pair(**kw):
    jeng = JaxEngine(JaxServerArgs(**ARGS, **kw, warmup_capture=False), tokenizer=CharTokenizer())
    eng = Engine(ServerArgs(device="cpu", **ARGS, **kw), tokenizer=CharTokenizer())
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def _generate(eng, sp_cls, requests, free=()):
    sps = [sp_cls(temperature=0.0, max_new_tokens=n, **kw) for kw, n in requests]
    sps += [sp_cls(temperature=0.0, max_new_tokens=n, ignore_eos=True) for n in free]
    outs = eng.generate(input_ids=[PROMPT] * len(sps), sampling_params=sps)
    return [o.output_ids for o in outs], [o.text for o in outs]


def test_constrained_greedy_matches_jax():
    """One batch of every grammar kind: the port's ids equal the JAX
    engine's, and the texts are the grammars' words. The literal-heavy
    regex alone takes fewer scheduler steps than half its tokens."""
    jeng, eng = _pair()
    ids, texts = _generate(eng, SamplingParams, GRAMMAR_REQUESTS)
    jids, _ = _generate(jeng, JaxSamplingParams, GRAMMAR_REQUESTS)
    assert ids == jids
    assert texts[0] in ("yes!", "no!") and texts[3] == "x" and texts[5].startswith("The answer is ")
    assert set(json.loads(texts[1])) == {"name", "age"}
    before = eng.scheduler.step_count
    ids, texts = _generate(eng, SamplingParams, GRAMMAR_REQUESTS[-1:])
    steps = eng.scheduler.step_count - before
    assert texts[0] in ("The answer is yes. Done!", "The answer is no. Done!")
    assert steps < len(ids[0]) // 2, (steps, len(ids[0]))
    eng.scheduler.check_memory_leak()


def test_grammars_beside_pipelined_windows_match_jax():
    """``enable_overlap=True``: a batch of grammar requests beside free ones
    that run on after the grammars finish. No batch with a grammar mask goes
    down the pipelined path, which runs once the grammars are done, and the
    ids equal the JAX engine's (overlap on there too)."""
    jeng, eng = _pair(enable_overlap=True, decode_pipeline_depth=2)
    runner = eng.scheduler.runner
    dispatched, inner = [], runner.dispatch_decode_window

    def dispatch(wb, *a, **kw):
        dispatched.append(wb.vocab_bitmask is None and runner._packed_supported(wb))
        return inner(wb, *a, **kw)

    runner.dispatch_decode_window = dispatch
    requests, free = GRAMMAR_REQUESTS[:3], (21, 30)
    ids, texts = _generate(eng, SamplingParams, requests, free)
    jids, _ = _generate(jeng, JaxSamplingParams, requests, free)
    assert ids == jids
    assert dispatched and all(dispatched)
    assert [len(i) for i in ids[-2:]] == list(free)


def test_chars_tokenizer_serves_grammars(tmp_path, monkeypatch):
    """``tokenizer_path="chars"`` (random-weight presets) loads the port's
    character tokenizer, and with it the grammar backend, whose native walk
    serves a regex; a directory named ``chars`` is loaded as a tokenizer's;
    without a tokenizer a grammar request is refused, and a grammar backend
    other than ``native`` is."""
    args = dict(preset="tiny-debug", random_weights=True, dtype="float32", device="cpu", page_size=4,
                max_total_tokens=512)
    backend.WALKS.clear()
    eng = Engine(ServerArgs(tokenizer_path="chars", **args))
    assert eng.tokenizer.encode("a") == [98] and eng.grammar_backend.native
    text = eng.generate(prompt="Q: A: ", sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=8, regex="(yes|no)!")).text
    assert text in ("yes!", "no!")
    assert backend.WALKS["fsm native"] > 0 and not backend.WALKS["fsm python"]
    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda path: ("pretrained", path))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.chdir(tmp_path)
    assert isinstance(load_tokenizer("chars"), CharTokenizer)
    (tmp_path / "chars").mkdir()
    assert load_tokenizer("chars") == ("pretrained", "chars")
    with pytest.raises(ValueError, match="tokenizer"):
        Engine(ServerArgs(**args)).generate(input_ids=[1, 2], sampling_params=SamplingParams(regex="a"))
    with pytest.raises(ValueError, match="grammar_backend"):
        ServerArgs(grammar_backend="python", **args).resolve()
