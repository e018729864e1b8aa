"""Speculative decoding in the port against the JAX package, on the CPU in
f32: ``speculative_algorithm`` ngram, draft and eagle, greedy and sampled
verification.

Each case of ``tests/test_speculative.py`` runs on a JAX engine and a port
engine that serve the same weights (the target's, the draft model's and
the EAGLE head's carried across with ``params_from_jax`` and
``eagle_params_from_jax``): the greedy ids are equal, the chosen logprobs
agree within ``LP_TOL``, and ngram and draft verify the same number of
steps and accept the same drafts. Then what the JAX file does not hold:
the distribution of sampled verification (a chi-square test against the
target's softmax), a rejection at the first row of a verify window that
straddles a page edge, a topping's request, which the port keeps off the
speculative path (the JAX engine verifies it on the base model), a
one-row batch padded to ``MIN_ROWS``, the refusals, and the HTTP server
with each algorithm.
"""

import json
import socket
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.core.req import Req as JaxReq
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.core.req import Req
from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
from scratchpad_tpu_torch.executor.model_runner import MIN_ROWS, WorkerBatch
from scratchpad_tpu_torch.executor.weight_loader import eagle_params_from_jax, params_from_jax
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048)
LP_TOL = 1e-4
DRAFT = dict(speculative_algorithm="draft", speculative_draft_preset="tiny-debug")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def load_jax_weights(jeng, eng):
    """Serve the JAX engine's target, draft and EAGLE weights in ``eng``."""
    js, ps = jeng.scheduler, eng.scheduler
    ps.runner.model.load_state_dict(params_from_jax(_np(js.runner.params), eng.model_config))
    if js.draft_runner is not None:
        dr = ps.draft_runner
        dr.model.load_state_dict(params_from_jax(_np(js.draft_runner.params), dr.model_config))
    if js.eagle is not None:
        ps.eagle.load_state_dict(eagle_params_from_jax(_np(js.eagle.params), eng.model_config))


def make_pair(model=None, **kw):
    """A JAX engine and a port engine on the same weights; ``model``
    overrides the tiny-debug preset's config on both sides."""
    cfgs = (None, None) if model is None else (
        jax_get_preset("tiny-debug", dtype="float32", **model), get_preset("tiny-debug", dtype="float32", **model)
    )
    jeng = JaxEngine(JaxServerArgs(**ARGS, **kw), model_config=cfgs[0])
    eng = Engine(ServerArgs(device="cpu", **ARGS, **kw), model_config=cfgs[1])
    load_jax_weights(jeng, eng)
    return jeng, eng


@pytest.fixture(scope="module")
def plain():
    return make_pair()


@pytest.fixture(scope="module")
def ngram():
    return make_pair(speculative_algorithm="ngram")


@pytest.fixture(scope="module")
def draft():
    return make_pair(**DRAFT)


@pytest.fixture(scope="module")
def eagle():
    return make_pair(speculative_algorithm="eagle")


@pytest.fixture(scope="module")
def eagle_echo():
    """EAGLE on a one-layer target whose head echoes the target: the
    head's layer is the target's, and ``fc`` passes the token's embedding
    through plus 0.01 of a seeded map of the feature (about a tenth of the
    embedding's scale). The head then sees the target's context shifted one
    position back (rope is relative), less the first token, and the
    target's final norm (weights one) does not move an argmax, so many
    drafts are accepted while the features still reach every K/V row and
    draft (at 0.05 none is accepted)."""
    jeng, eng = make_pair(model=dict(num_hidden_layers=1), speculative_algorithm="eagle")
    H = eng.model_config.hidden_size
    feat = np.random.default_rng(17).standard_normal((H, H)).astype(np.float32) / np.sqrt(H)
    fc = np.concatenate([np.eye(H, dtype=np.float32), 0.01 * feat])  # [2H, H]: x @ fc
    je = jeng.scheduler.eagle
    je.params = {"layers": jeng.scheduler.runner.params["layers"], "fc": jax.numpy.asarray(fc), "fc_b": None}
    eng.scheduler.eagle.load_state_dict(eagle_params_from_jax(_np(je.params), eng.model_config))
    return jeng, eng


def _sp(jax_side, **kw):
    return (JaxSamplingParams if jax_side else SamplingParams)(**kw)


def run_both(pair, prompts, **sp):
    """Both engines' outputs and the spec counters each run added."""
    jeng, eng = pair
    single = not isinstance(prompts[0], list)
    n = 1 if single else len(prompts)
    out = []
    for e, jx in ((jeng, True), (eng, False)):
        s0, a0 = e.scheduler.num_spec_steps, e.scheduler.num_spec_accepted
        o = e.generate(input_ids=prompts, sampling_params=[_sp(jx, **sp)] * n if not single
                       else _sp(jx, **sp), return_logprob=True)
        o = [o] if single else o
        out.append((o, e.scheduler.num_spec_steps - s0, e.scheduler.num_spec_accepted - a0))
    return out


def assert_same(jo, po):
    for j, p in zip(jo, po):
        assert p.output_ids == j.output_ids
        np.testing.assert_allclose(p.output_token_logprobs, j.output_token_logprobs, atol=LP_TOL, rtol=0)


def greedy_prompts(kind):
    rng = np.random.default_rng(0)
    if kind == "repetitive":
        base = rng.integers(1, 100, 6).tolist()
        return [base * 4, (base + [7, 9]) * 3]
    return [rng.integers(1, 500, n).tolist() for n in (17, 31)]


GREEDY = dict(temperature=0.0, ignore_eos=True)


# ------------------------------------------------------------ the JAX cases


def test_ngram_proposer(ngram):
    jeng, eng = ngram
    for ids, k in (([1, 2, 3, 4, 5, 1, 2, 3], 4), ([7, 8, 9], 4), ([5, 6] * 5, 3)):
        j = jeng.scheduler._propose_ngram(JaxReq(rid="x", origin_input_ids=ids, sampling_params=JaxSamplingParams()), k)
        p = eng.scheduler._propose_ngram(Req(rid="x", origin_input_ids=ids, sampling_params=SamplingParams()), k)
        assert p == j
    assert p == [5, 6]  # the latest earlier match, cut at the end of the context


@pytest.mark.parametrize("prompt_kind", ["repetitive", "random"])
def test_spec_matches_plain_greedy(plain, ngram, prompt_kind):
    prompts = greedy_prompts(prompt_kind)
    (jo, js, ja), (po, ps, pa) = run_both(ngram, prompts, max_new_tokens=24, **GREEDY)
    assert_same(jo, po)
    assert (ps, pa) == (js, ja)
    (ref, _, _), _ = run_both(plain, prompts, max_new_tokens=24, **GREEDY)
    assert [o.output_ids for o in po] == [o.output_ids for o in ref]
    if prompt_kind == "repetitive":
        assert ps > 0
    ngram[1].scheduler.check_memory_leak()


@pytest.mark.parametrize("algo", [dict(speculative_algorithm="ngram"), DRAFT], ids=["ngram", "draft"])
def test_spec_on_w4a8_int8_kv_matches_jax(algo):
    """Speculation on a W4A8 target over an int8 KV pool (the target's
    4-bit codes carried across; the draft model unquantized on a pool of
    the model dtype, as both packages build it): the same greedy ids and
    accepted drafts as the JAX engine, the chosen logprobs within
    ``LP_TOL``."""
    jeng, eng = make_pair(quantization="w4a8", kv_cache_dtype="int8", **algo)
    runner = eng.scheduler.runner
    assert runner.kv_cache.quantized and runner.kv_cache.k.dtype == torch.int8
    (jo, js, ja), (po, ps, pa) = run_both((jeng, eng), greedy_prompts("repetitive"), max_new_tokens=24, **GREEDY)
    assert_same(jo, po)
    assert ps > 0 and (ps, pa) == (js, ja)
    eng.scheduler.check_memory_leak()


def test_spec_acceptance_on_forced_repetition(ngram):
    (jo, js, ja), (po, ps, pa) = run_both(ngram, [5, 6, 7, 8] * 6, max_new_tokens=32, **GREEDY)
    assert_same(jo, po)
    assert len(po[0].output_ids) == 32 and pa > 0 and (ps, pa) == (js, ja)


def test_draft_model_same_weights_accepts_everything(draft):
    prompt = np.random.default_rng(3).integers(1, 500, 13).tolist()
    (jo, js, ja), (po, ps, pa) = run_both(draft, prompt, max_new_tokens=24, **GREEDY)
    assert_same(jo, po)
    k = draft[1].args.speculative_num_draft_tokens
    assert ps > 0 and pa >= (ps - 1) * k and (ps, pa) == (js, ja)
    draft[1].scheduler.check_memory_leak()


def test_draft_model_matches_plain_greedy(plain, draft):
    """A wrong draft (its weights times 1.25 on both sides) changes only
    the acceptance, never the tokens."""
    jeng, eng = draft
    jdr, pdr = jeng.scheduler.draft_runner, eng.scheduler.draft_runner
    saved_j, saved_p = jdr.params, {k: v.clone() for k, v in pdr.model.state_dict().items()}
    jdr.params = jax.tree.map(lambda x: x * 1.25, jdr.params)
    pdr.model.load_state_dict(params_from_jax(_np(jdr.params), pdr.model_config))
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 500, n).tolist() for n in (11, 29)]
        (jo, js, ja), (po, ps, pa) = run_both(draft, prompts, max_new_tokens=20, **GREEDY)
        assert_same(jo, po)
        assert (ps, pa) == (js, ja) and pa < ps * eng.args.speculative_num_draft_tokens
        (ref, _, _), _ = run_both(plain, prompts, max_new_tokens=20, **GREEDY)
        assert [o.output_ids for o in po] == [o.output_ids for o in ref]
    finally:
        jdr.params = saved_j
        pdr.model.load_state_dict(saved_p)
    eng.scheduler.check_memory_leak()


def test_draft_model_after_plain_decode_catches_up(plain, draft):
    """min_new_tokens keeps the first steps on plain decode; the draft then
    catches its K/V up before it speculates."""
    sp = dict(temperature=0.0, max_new_tokens=20, min_new_tokens=6, ignore_eos=True)
    (jo, _, _), (po, ps, _) = run_both(draft, [9, 10, 11, 12, 13], **sp)
    assert_same(jo, po)
    (ref, _, _), _ = run_both(plain, [9, 10, 11, 12, 13], **sp)
    assert po[0].output_ids == ref[0].output_ids and ps > 0


def test_spec_respects_stop_and_sampled_fallback(ngram):
    (jo, _, _), (po, _, _) = run_both(ngram, [3, 4] * 8, temperature=0.0, max_new_tokens=16)
    assert_same(jo, po)
    assert len(po[0].output_ids) <= 16
    _, (po, _, _) = run_both(ngram, [9, 10, 9, 10], temperature=0.8, max_new_tokens=8, ignore_eos=True)
    assert len(po[0].output_ids) == 8
    ngram[1].scheduler.check_memory_leak()


@pytest.mark.parametrize("pair", ["ngram", "eagle"])
def test_spec_sampled_topk1_matches_greedy(plain, request, pair):
    """Temperature > 0 with top-k 1 is the argmax: sampled verification
    gives the greedy tokens and accepts drafts."""
    pr = request.getfixturevalue(pair)
    prompts = greedy_prompts("repetitive")
    k1 = dict(temperature=0.7, top_k=1, max_new_tokens=24, ignore_eos=True)
    (jo, _, _), (po, ps, pa) = run_both(pr, prompts, **k1)
    assert [o.output_ids for o in po] == [o.output_ids for o in jo]
    (ref, _, _), _ = run_both(plain, prompts, max_new_tokens=24, **GREEDY)
    assert [o.output_ids for o in po] == [o.output_ids for o in ref]
    assert ps > 0 and (pa > 0 or pair == "eagle")  # a seeded EAGLE head's drafts miss


def test_spec_sampled_mixed_batch(plain, ngram):
    """Greedy and sampled rows verify together; the greedy row's tokens do
    not depend on its sampled neighbour."""
    rng = np.random.default_rng(1)
    base = rng.integers(1, 100, 5).tolist()
    prompts = [base * 5, (base + [3]) * 4]
    jeng, eng = ngram
    sps = [SamplingParams(max_new_tokens=20, **GREEDY),
           SamplingParams(temperature=0.9, top_p=0.8, max_new_tokens=20, ignore_eos=True)]
    outs = eng.generate(input_ids=prompts, sampling_params=sps)
    (ref, _, _), _ = run_both(plain, prompts[0], max_new_tokens=20, **GREEDY)
    assert outs[0].output_ids == ref[0].output_ids and len(outs[1].output_ids) == 20
    eng.scheduler.check_memory_leak()


def test_spec_sampled_draft_model(plain, draft):
    k1 = dict(temperature=0.5, top_k=1, max_new_tokens=16, ignore_eos=True)
    prompt = np.random.default_rng(2).integers(1, 500, 12).tolist()
    (jo, _, _), (po, _, pa) = run_both(draft, prompt, **k1)
    assert po[0].output_ids == jo[0].output_ids and pa > 0
    (jo, _, _), (po, _, _) = run_both(draft, [11, 12, 13, 14] * 4, **k1)
    (ref, _, _), _ = run_both(plain, [11, 12, 13, 14] * 4, max_new_tokens=16, **GREEDY)
    assert po[0].output_ids == jo[0].output_ids == ref[0].output_ids
    draft[1].scheduler.check_memory_leak()


def test_eagle_matches_plain_greedy(plain, eagle):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 500, n).tolist() for n in (9, 26)]
    (jo, js, _), (po, ps, _) = run_both(eagle, prompts, max_new_tokens=16, **GREEDY)
    assert_same(jo, po)
    (ref, _, _), _ = run_both(plain, prompts, max_new_tokens=16, **GREEDY)
    assert [o.output_ids for o in po] == [o.output_ids for o in ref]
    assert ps > 0 and ps == js  # eagle always proposes
    eagle[1].scheduler.check_memory_leak()


def test_eagle_multi_turn_and_radix(plain, eagle):
    """A radix hit keeps exactness; a sampled request between (no
    features captured) does not spoil later greedy runs."""
    p = [7, 8, 9, 10, 11, 12, 13, 14]
    (jo, _, _), (a, _, _) = run_both(eagle, p, max_new_tokens=10, **GREEDY)
    assert_same(jo, a)
    run_both(eagle, [3, 4, 5], temperature=0.9, max_new_tokens=4, ignore_eos=True)
    (jo, _, _), (b, _, _) = run_both(eagle, p, max_new_tokens=10, **GREEDY)
    assert_same(jo, b)
    assert b[0].output_ids == a[0].output_ids and b[0].cached_tokens > 0
    eagle[1].scheduler.check_memory_leak()


def _eagle_slots(sched, loc, jax_side):
    """The EAGLE pool's K and V [M, Hkv, D] at token slots ``loc``: the
    JAX pool holds K and V interleaved per head, ``[pages, ps, 2 Hkv, Dp]``."""
    pool = sched.eagle.kv_cache
    if jax_side:
        kv = np.asarray(pool.kv)
        ps, Hkv, D = kv.shape[1], kv.shape[2] // 2, sched.eagle.cfg.head_dim
        rows = kv[loc // ps, loc % ps].reshape(len(loc), Hkv, 2, -1)[..., :D]
        return rows[:, :, 0], rows[:, :, 1]
    ps = pool.k.shape[2]
    return tuple(t[0, loc // ps, loc % ps].float().numpy() for t in (pool.k, pool.v))


def record_eagle(monkeypatch, sched, jax_side):
    """Record the scheduler's EAGLE drafts ([B][k] a step, or None) and each
    ``write_pairs`` call: its inputs, the pool's K/V at the slots it wrote,
    and whether a verify step made it (the re-extension of an accepted
    span) or an extend."""
    log = dict(drafts=[], pairs=[])
    propose, write = sched._propose_eagle, sched.eagle.write_pairs

    def propose_and_log(batch, k):
        d = propose(batch, k)
        log["drafts"].append(d)
        return d

    def write_and_log(w):
        write(w)
        loc = np.asarray(w["out_cache_loc"], np.int64)
        verify = sys._getframe(1).f_code.co_name == "_spec_decode_step"
        log["pairs"].append((w, *_eagle_slots(sched, loc, jax_side), verify))

    monkeypatch.setattr(sched, "_propose_eagle", propose_and_log)
    monkeypatch.setattr(sched.eagle, "write_pairs", write_and_log)
    return log


@pytest.mark.parametrize("head", ["seeded", "echo"])
def test_eagle_drafts_and_pairs_match_jax(request, monkeypatch, head):
    """The port's EAGLE proposer against the JAX head on the same weights:
    the [k, B] drafts of every step are equal, both engines verify and
    accept the same counts, and every ``write_pairs`` call (after an extend
    and after each verify) gets the same pairs and features and leaves the
    same K/V at the slots it wrote. The seeded head's drafts miss; the echo
    head's are accepted, so the accepted spans are re-extended with the
    true features, greedy and sampled at top-k 1."""
    jeng, eng = request.getfixturevalue("eagle" if head == "seeded" else "eagle_echo")
    logs = [record_eagle(monkeypatch, e.scheduler, jx) for e, jx in ((jeng, True), (eng, False))]
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 500, n).tolist() for n in (13, 22)]
    (jo, js, ja), (po, ps, pa) = run_both((jeng, eng), prompts, max_new_tokens=20, **GREEDY)
    assert_same(jo, po)
    assert (ps, pa) == (js, ja) and ps > 0
    k1 = dict(temperature=0.7, top_k=1, max_new_tokens=20, ignore_eos=True)
    eng.flush_cache(), jeng.flush_cache()
    (sj, sjs, sja), (sp, sps, spa) = run_both((jeng, eng), prompts, **k1)
    assert [o.output_ids for o in sp] == [o.output_ids for o in sj] == [o.output_ids for o in po]
    assert (sps, spa) == (sjs, sja)
    jlog, plog = logs
    assert plog["drafts"] == jlog["drafts"] and any(d is not None for d in plog["drafts"])
    assert len(plog["pairs"]) == len(jlog["pairs"])
    for (jw, jk, jv, jverify), (pw, pk, pv, pverify) in zip(jlog["pairs"], plog["pairs"]):
        assert pverify == jverify
        for key in ("tokens", "positions", "out_cache_loc", "req_indices", "page_table", "seq_lens", "extend_lens"):
            np.testing.assert_array_equal(pw[key], jw[key], err_msg=key)
        np.testing.assert_allclose(pw["feats"], jw["feats"], atol=LP_TOL, rtol=0)
        np.testing.assert_allclose(pk, jk, atol=LP_TOL, rtol=0)
        np.testing.assert_allclose(pv, jv, atol=LP_TOL, rtol=0)
    re_extended = sum(len(w["tokens"]) for w, *_, verify in plog["pairs"] if verify)
    if head == "echo":
        assert pa > 0 and spa > 0 and re_extended > 0
    else:
        assert pa == 0 and re_extended == 0  # nothing accepted, nothing to re-extend
    eng.scheduler.check_memory_leak()


def test_eagle_head_import_format(eagle):
    """A trained EAGLE-1 checkpoint (``fc.weight`` + ``layers.0.*``) maps
    onto the head as the JAX converter maps it."""
    jeng, eng = eagle
    cfg = eng.model_config
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    rng = np.random.default_rng(0)
    shapes = {
        "fc.weight": (H, 2 * H),
        "layers.0.self_attn.q_proj.weight": (Hq * D, H), "layers.0.self_attn.k_proj.weight": (Hkv * D, H),
        "layers.0.self_attn.v_proj.weight": (Hkv * D, H), "layers.0.self_attn.o_proj.weight": (H, Hq * D),
        "layers.0.mlp.gate_proj.weight": (I, H), "layers.0.mlp.up_proj.weight": (I, H),
        "layers.0.mlp.down_proj.weight": (H, I),
        "layers.0.input_layernorm.weight": (H,), "layers.0.post_attention_layernorm.weight": (H,),
    }
    state = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    got = eng.scheduler.eagle.convert_hf_state(state, torch.float32)
    want = eagle_params_from_jax(_np(jeng.scheduler.eagle.convert_hf_state(state, jax.numpy.float32)), cfg)
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert got["fc.weight"].shape == (H, 2 * H)
    with pytest.raises(KeyError, match="fc.weight"):
        eng.scheduler.eagle.convert_hf_state({k: v for k, v in state.items() if k != "fc.weight"})


# ----------------------------------------------------------- beyond the JAX


def _pages(runner, n_tokens):
    ps = runner.page_size
    pages = runner.page_allocator.alloc(-(-n_tokens // ps))
    pos = np.arange(n_tokens)
    return pages, pages[pos // ps] * ps + pos % ps


def _verify_batch(runner, ctx, drafts, n, pages, loc, sinfo_kw=None):
    """``n`` identical requests verifying ``drafts`` after ``ctx``, their K/V
    on the same ``pages`` (every request writes the same values); greedy
    unless ``sinfo_kw`` says otherwise."""
    kw = dict(temperature=0.0, top_p=1.0, top_k=runner.model_config.vocab_size, min_p=0.0)
    kw.update(sinfo_kw or {})
    total, c = len(ctx) + len(drafts), len(ctx) - 1
    return WorkerBatch(
        mode=ForwardMode.EXTEND, tokens=np.tile(np.asarray([ctx[-1]] + drafts), n),
        positions=np.tile(np.arange(c, total), n), out_cache_loc=np.tile(loc[c:total], n),
        req_indices=np.repeat(np.arange(n), len(drafts) + 1), page_table=np.tile(pages, (n, 1)),
        seq_lens=np.full(n, total), extend_lens=np.full(n, len(drafts) + 1),
        sampling_info=SamplingBatchInfo(**{
            k: np.full(n, v, np.int32 if k == "top_k" else np.float32) for k, v in kw.items()
        }),
    )


def test_sampled_verification_is_distribution_exact(ngram):
    """At one context, 3,000 requests verify the same drafts at temperature
    0.8 and top-p 0.95. The first emitted token (row 0's sample) must follow
    the target's filtered softmax at that row, and the second (row 1's
    sample, emitted where row 0 accepted the first draft) the softmax at
    row 1: each chi-square statistic below its 0.999 quantile (bins of an
    expected count under 5 pooled). Two calls draw different samples (the
    generator's stream moves on across chunks and steps)."""
    _, eng = ngram
    runner = eng.scheduler.runner
    ctx = np.random.default_rng(21).integers(1, 500, 10).tolist()
    temp, top_p, n = 0.8, 0.95, 3000
    pages, loc = _pages(runner, len(ctx) + 2)
    try:
        c = len(ctx) - 1
        sinfo = SamplingBatchInfo.from_reqs([], 1, runner.model_config.vocab_size)
        runner.run_extend(WorkerBatch(
            mode=ForwardMode.EXTEND, tokens=np.asarray(ctx[:-1]), positions=np.arange(c),
            out_cache_loc=loc[:c], req_indices=np.zeros(c, np.int64), page_table=pages[None],
            seq_lens=np.array([c]), extend_lens=np.array([c]), sampling_info=sinfo,
        ))
        # the first draft is the target's argmax at row 0
        d0 = int(runner.run_spec_verify(_verify_batch(runner, ctx, [0, 0], 1, pages, loc))[0][0])
        with torch.inference_mode():
            _, _, _, h = runner._hidden(_verify_batch(runner, ctx, [d0, 0], 1, pages, loc))
            logits = runner.model.head_logits(h[:2]).double()
        probs = []
        for row in logits:
            p = torch.softmax(row / temp, dim=-1)
            order = torch.argsort(p, descending=True)
            keep = torch.cumsum(p[order], 0) - p[order] < top_p  # the nucleus
            q = torch.zeros_like(p)
            q[order[keep]] = p[order[keep]]
            probs.append((q / q.sum()).numpy())
        wb = _verify_batch(runner, ctx, [d0, 0], n, pages, loc, dict(temperature=temp, top_p=top_p))
        ids, _ = runner.run_spec_verify_sampled(wb)
        again, _ = runner.run_spec_verify_sampled(wb)
    finally:
        runner.page_allocator.free(pages)
    rows = ids.reshape(n, 3)
    assert (again != ids).mean() > 0.1

    def chi2(samples, p):
        counts = np.bincount(samples, minlength=len(p)).astype(float)
        assert counts[p == 0].sum() == 0  # nothing outside the nucleus
        exp = p * len(samples)
        big = exp >= 5
        obs = np.append(counts[big], counts[~big].sum())
        e = np.append(exp[big], exp[~big].sum())
        obs, e = (obs, e) if e[-1] > 0 else (obs[:-1], e[:-1])
        stat = ((obs - e) ** 2 / e).sum()
        return stat, stats.chi2.ppf(0.999, len(e) - 1)

    stat, bound = chi2(rows[:, 0], probs[0])
    assert stat < bound, (stat, bound)
    # row 1's draw is independent of row 0's, so every request's row-1
    # sample counts for the second emitted token's law
    assert (rows[:, 0] == d0).any()
    stat, bound = chi2(rows[:, 1], probs[1])
    assert stat < bound, (stat, bound)


def test_rejection_at_a_page_edge_leaves_the_pool_consistent(plain, draft):
    """Draft windows of k + 1 = 5 rows from position 14 on (page size 4)
    straddle page edges; a draft model with wrong weights is rejected at
    the first row. The rejected rows' K/V lie past each request's length,
    and the tokens stay the target's greedy chain."""
    jeng, eng = draft
    pdr = eng.scheduler.draft_runner
    saved = {k: v.clone() for k, v in pdr.model.state_dict().items()}
    with torch.no_grad():
        for v in pdr.model.state_dict().values():
            v.neg_()  # a draft that proposes other tokens
    try:
        prompt = np.random.default_rng(8).integers(1, 500, 14).tolist()
        s0, a0 = eng.scheduler.num_spec_steps, eng.scheduler.num_spec_accepted
        out = eng.generate(input_ids=prompt, sampling_params=SamplingParams(max_new_tokens=12, **GREEDY))
        steps, acc = eng.scheduler.num_spec_steps - s0, eng.scheduler.num_spec_accepted - a0
    finally:
        pdr.model.load_state_dict(saved)
    (ref, _, _), _ = run_both(plain, prompt, max_new_tokens=12, **GREEDY)
    assert out.output_ids == ref[0].output_ids
    assert steps > 0 and acc < steps  # rejections happened
    eng.scheduler.check_memory_leak()


def test_a_topping_request_stays_on_plain_decode():
    """The JAX verify batch carries no adapter table, so its ngram engine
    verifies a topping's request on the base model: its tokens leave the
    topping's own greedy chain. The port keeps such rows on plain decode and
    serves the topping's chain."""
    from test_torch_toppings import lora_state

    cfg = get_preset("tiny-debug")
    state = lora_state(cfg, rank=8, seed=4)
    prompt = [5, 6, 7, 8] * 6
    outs = {}
    for kw in (dict(), dict(speculative_algorithm="ngram")):
        jeng, eng = make_pair(**kw)
        for e, jx in ((jeng, True), (eng, False)):
            e.register_topping("ad1", state=state, scaling=1.0)
            o = e.generate(input_ids=prompt, sampling_params=_sp(jx, max_new_tokens=16, **GREEDY), topping="ad1")
            outs[(bool(kw), jx)] = (o.output_ids, e.scheduler.num_spec_steps)
    chain = outs[(False, True)][0]
    assert outs[(False, False)][0] == chain  # the port's plain engine serves the topping
    assert outs[(True, True)][0] != chain and outs[(True, True)][1] > 0  # the JAX fault
    assert outs[(True, False)] == (chain, 0)


def test_speculation_survives_pipelined_windows():
    """With ``enable_overlap`` (the default on the card) the JAX engine
    chains pipelined windows once a window ran without drafts, and its ngram
    engine speculates no more; the port keeps speculative engines off the
    pipeline, so each window tries its drafts, and the tokens are the same."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, 40).tolist() for _ in range(2)]
    steps, ids = {}, {}
    for overlap in (False, True):
        jeng, eng = make_pair(speculative_algorithm="ngram", enable_overlap=overlap)
        (jo, js, _), (po, ps, _) = run_both((jeng, eng), prompts, max_new_tokens=48, **GREEDY)
        assert_same(jo, po)
        steps[overlap], ids[overlap] = (js, ps), [o.output_ids for o in po]
        eng.scheduler.check_memory_leak()
    assert ids[True] == ids[False]
    assert steps[False][0] == steps[False][1] == steps[True][1] > 0  # the port speculates either way
    assert steps[True][0] == 0  # the JAX engine stops


def test_one_row_batches_pad_to_min_rows(plain):
    """A lone one-token request reaches the model at ``MIN_ROWS`` rows and
    tokens (a one-row matmul would take torch's vector path), so its
    logprobs equal those it gets beside another request, bit for bit."""
    _, eng = plain
    runner = eng.scheduler.runner
    sinfo = SamplingBatchInfo.from_reqs([], 1, eng.model_config.vocab_size)
    for mode in (ForwardMode.EXTEND, ForwardMode.DECODE):
        wb = WorkerBatch(
            mode=mode, tokens=np.array([7]), positions=np.array([0]), out_cache_loc=np.array([4]),
            req_indices=np.array([0]), page_table=np.array([[1]], np.int32), seq_lens=np.array([1]),
            extend_lens=np.array([1]), sampling_info=sinfo,
        )
        meta, _, _ = runner._pad_to_buckets(wb)
        assert meta.batch_size == MIN_ROWS and meta.num_tokens == MIN_ROWS
    p = np.random.default_rng(12).integers(1, 500, 23).tolist()
    sp = SamplingParams(max_new_tokens=8, **GREEDY)
    eng.flush_cache()
    one = eng.generate(input_ids=p, sampling_params=sp, return_logprob=True)
    eng.flush_cache()
    two = eng.generate(input_ids=[p, p[::-1]], sampling_params=[sp] * 2, return_logprob=True)
    assert one.output_token_logprobs == two[0].output_token_logprobs


@pytest.mark.parametrize(
    "setting,error,match",
    [
        (dict(speculative_algorithm="medusa"), ValueError, "unknown speculative_algorithm"),
        (dict(speculative_algorithm="draft"), ValueError, "speculative_draft_preset"),
        (dict(speculative_algorithm="ngram", enable_param_offload=True), ValueError, "incompatible"),
        (dict(host_kv_cache_tokens=1024, **DRAFT), ValueError, "host_kv_cache_tokens"),
    ],
    ids=["unknown", "draft-without-model", "offload", "host-tier-with-draft"],
)
def test_spec_settings_refused(setting, error, match):
    with pytest.raises(error, match=match):
        ServerArgs(preset="tiny-debug", device="cpu", **setting).resolve()


@pytest.mark.parametrize(
    "preset,model,match",
    [
        ("tiny-gemma2", {}, "Llama-family"),
        ("tiny-debug", dict(architecture="MixtralForCausalLM", num_experts=4, num_experts_per_tok=2),
         "Llama-family"),
        ("tiny-debug", dict(logit_softcap=30.0), "soft-capped"),
    ],
    ids=["gemma", "mixtral", "softcap"],
)
def test_eagle_refuses_other_targets(preset, model, match):
    cfg = get_preset(preset, dtype="float32", **model)
    with pytest.raises(ValueError, match=match):
        Engine(ServerArgs(device="cpu", speculative_algorithm="eagle", **ARGS), model_config=cfg)


def test_draft_refuses_a_multimodal_target():
    from test_torch_vision import model_kw
    from scratchpad_tpu_torch.config import ModelConfig

    cfg = ModelConfig(**model_kw("llava"), dtype="float32")
    with pytest.raises(ValueError, match="text model"):
        Engine(ServerArgs(device="cpu", **DRAFT, **ARGS), model_config=cfg)


@pytest.mark.parametrize("algo", ["ngram", "draft", "eagle"])
def test_spec_served_over_http(plain, request, algo):
    """``sp serve --speculative-algorithm <algo>``'s flags, then
    ``/v1/completions`` greedy (the plain engine's tokens) and sampled at
    top-k 1, and ``/system_info``'s spec counters."""
    from scratchpad_tpu_torch.cli.sp import build_parser
    from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["serve", "--preset", "tiny-debug", "--random-weights", "--dtype", "float32", "--page-size", "4",
            "--device", "cpu", "--max-total-tokens", "2048", "--port", str(port),
            "--speculative-algorithm", algo]
    if algo == "draft":
        argv += ["--speculative-draft-preset", "tiny-debug"]
    args = ServerArgs.from_cli_args(build_parser().parse_args(argv))
    assert args.speculative_algorithm == algo
    eng = Engine(args)
    load_jax_weights(request.getfixturevalue(algo)[0], eng)  # the same JAX weights as that pair's
    srv = ServerThread(ServerApp(eng, eng.args))
    prompt = [5, 6, 7, 8] * 5

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        body = dict(model="m", prompt=prompt, max_tokens=12, ignore_eos=True, logprobs=1)
        greedy = post("/v1/completions", dict(body, temperature=0.0))
        k1 = post("/v1/completions", dict(body, temperature=0.7, top_k=1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/system_info", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        srv.stop()
    (ref, _, _), _ = run_both(plain, prompt, max_new_tokens=12, **GREEDY)
    ids = lambda c: [int(t) for t in c["logprobs"]["tokens"]]
    assert ids(greedy["choices"][0]) == ids(k1["choices"][0]) == ref[0].output_ids
    assert info["spec_steps"] > 0 and info["spec_accepted_tokens"] >= 0
    assert eng.scheduler.num_spec_steps == info["spec_steps"]
