"""The port's custom logit processors, and penalties across a decode window,
against the JAX package's, on the CPU in f32.

- ``BannedTokensProcessor`` of both packages on the same seeded logits: equal
  (an id past the vocabulary bans nothing on either side).
- ``sample`` over one batch (from each package's ``from_reqs`` on the same
  requests) with two processor groups, a per-row ``custom_params`` scalar,
  rows without a processor, ``logit_bias``, penalties and a grammar
  bitmask: the greedy ids bit for bit, the log-softmax within 1e-5; the
  processors run before the bias, the penalties and the mask.
- A processor that writes in place changes only its own rows.
- ``to_str`` / ``from_str``: a round trip, one object for equal payloads.
- Greedy engines (tiny-debug, the JAX engine's weights through
  ``params_from_jax``) with processors in a mixed batch: the JAX engine's
  ids; with ``enable_overlap`` no pipelined window carries a processor row.
- Penalties carried across a decode window of 16 steps: the JAX engine's
  ids.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.batch_info import SamplingBatchInfo as JaxInfo
from scratchpad_tpu.sampling.custom_logit_processor import BannedTokensProcessor as JaxBanned
from scratchpad_tpu.sampling.custom_logit_processor import CustomLogitProcessor as JaxProcessor
from scratchpad_tpu.sampling.sampler import sample as jax_sample
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.sampling.custom_logit_processor import (
    BannedTokensProcessor,
    CustomLogitProcessor,
)
from scratchpad_tpu_torch.sampling.sampler import sample
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine

V = 512


class ShiftByParam(CustomLogitProcessor):
    """Adds ``params["boost"]`` (one f32 a row) to one token's logit, in
    place, as the contract allows."""

    def __init__(self, token_id: int):
        self.token_id = int(token_id)

    def __call__(self, logits, params):
        logits[:, self.token_id] += params["boost"]
        return logits


class JaxShiftByParam(JaxProcessor):
    def __init__(self, token_id: int):
        self.token_id = int(token_id)

    def __call__(self, logits, params):
        return logits.at[:, self.token_id].add(params["boost"])


def test_banned_tokens_match_jax():
    logits = np.random.default_rng(0).normal(size=(3, V)).astype(np.float32)
    ids = [5, 77, 511, 600, 77]
    want = np.asarray(JaxBanned(ids)(jnp.asarray(logits), {}))
    got = BannedTokensProcessor(ids)(torch.from_numpy(logits), {}).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, [5, 77, 511]] == -1e30).all()
    assert BannedTokensProcessor(ids) == BannedTokensProcessor(ids)
    assert hash(BannedTokensProcessor(ids)) == hash(BannedTokensProcessor(ids))
    assert BannedTokensProcessor(ids) != BannedTokensProcessor([5])


def _req(sp, out_ids, prompt):
    return types.SimpleNamespace(sampling_params=sp, output_ids=out_ids, origin_input_ids=prompt)


def test_sample_matches_jax():
    """Six greedy rows: banned ids on rows 0 and 2 (one processor object),
    a boost of 50 and of 0 on rows 1 and 3 (another, with its param),
    nothing on rows 4 and 5; a bias on rows 0 and 4 that the ban must
    still beat, penalties on every row and a bitmask on rows 2 and 5."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, V)).astype(np.float32) * 3
    top = logits.argmax(-1)
    banned = [int(top[0]), int(top[2]), 300]
    kw = [
        dict(processor="ban", logit_bias={int(top[0]): 5.0, 300: 40.0}),
        dict(processor="shift", custom_params={"boost": 50.0}),
        dict(processor="ban"),
        dict(processor="shift", custom_params={"boost": 0.0}),
        dict(logit_bias={7: 30.0}),
        dict(),
    ]
    prompts = [rng.integers(1, V, 9).tolist() for _ in kw]
    prompts[1][0] = 123  # the repetition penalty then tells a boost before it from one after
    outs = [rng.integers(1, V, 4).tolist() for _ in kw]
    procs = {"ban": (BannedTokensProcessor(banned), JaxBanned(banned)),
             "shift": (ShiftByParam(123), JaxShiftByParam(123))}
    reqs, jreqs = [], []
    for k, p, o in zip(kw, prompts, outs):
        k = dict(k)
        name = k.pop("processor", None)
        common = dict(temperature=0.0, frequency_penalty=0.5, presence_penalty=0.25,
                      repetition_penalty=1.3, **k)
        port_proc, jax_proc = procs[name] if name else (None, None)
        reqs.append(_req(SamplingParams(custom_logit_processor=port_proc, **common), o, p))
        jreqs.append(_req(JaxSamplingParams(custom_logit_processor=jax_proc, **common), o, p))
    info = SamplingBatchInfo.from_reqs(reqs, 6, V)
    jinfo = JaxInfo.from_reqs(jreqs, 6, V)
    assert len(info.custom_processors) == 2 and info.custom_proc_mask.tolist() == [
        [True, False, True, False, False, False], [False, True, False, True, False, False]]
    assert list(info.custom_proc_params[1]) == ["boost"]
    bitmask = np.full((6, V // 32), 0xFFFFFFFF, np.uint32)
    bitmask[[2, 5], : V // 64] = 0  # rows 2 and 5: only the upper half allowed
    info.vocab_bitmask = bitmask
    jinfo = jax.tree.map(jnp.asarray, jinfo)
    jinfo.vocab_bitmask = jnp.asarray(bitmask)
    want_ids, want_lp = jax_sample(jnp.asarray(logits), jinfo, jax.random.PRNGKey(0))
    got_ids, got_lp = sample(torch.from_numpy(logits), info.to("cpu"), None)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    ids = got_ids.tolist()
    assert ids[0] not in banned and ids[2] not in banned and ids[1] == 123 and ids[4] == 7
    assert ids[2] >= V // 2 and ids[5] >= V // 2


def test_in_place_processor_leaves_other_rows():
    """A processor that writes its whole input in place (a ban and a boost)
    on row 0 of a batch of two requests and a padding row: the free row's
    id and log-softmax equal its run alone, and the caller's logits are
    untouched."""
    logits = torch.from_numpy(np.random.default_rng(2).normal(size=(3, V)).astype(np.float32) * 3)
    before = logits.clone()
    free_id = int(logits[1].argmax())

    class BanAndShift(ShiftByParam):
        def __call__(self, logits, params):
            logits[:, free_id] = -1e30
            return super().__call__(logits, params)

    reqs = [_req(SamplingParams(temperature=0.0, custom_logit_processor=BanAndShift(123),
                                custom_params={"boost": 1e3}), [], [1]),
            _req(SamplingParams(temperature=0.0), [], [1])]
    ids, lp = sample(logits, SamplingBatchInfo.from_reqs(reqs, 3, V).to("cpu"), None)
    solo_ids, solo_lp = sample(logits[1:2].clone(), SamplingBatchInfo.from_reqs(reqs[1:], 1, V).to("cpu"), None)
    assert ids.tolist()[:2] == [123, free_id] and solo_ids.tolist() == [free_id]
    np.testing.assert_array_equal(lp[1].numpy(), solo_lp[0].numpy())
    assert torch.equal(logits, before)


def test_to_str_round_trip():
    proc = BannedTokensProcessor([3, 4])
    s = proc.to_str()
    a, b = CustomLogitProcessor.from_str(s), CustomLogitProcessor.from_str(s)
    assert a is b and a == proc and a is not proc
    assert isinstance(a, BannedTokensProcessor) and a.token_ids == (3, 4)
    assert CustomLogitProcessor.from_str(BannedTokensProcessor([3]).to_str()) != a


ENGINE_ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4,
                   max_total_tokens=2048, chunked_prefill_size=16)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine (CPU, pipelined windows on) on the
    same weights."""
    jeng = JaxEngine(JaxServerArgs(**ENGINE_ARGS, warmup_capture=False))
    eng = Engine(ServerArgs(device="cpu", enable_overlap=True, **ENGINE_ARGS))
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def _generate(jeng, eng, prompts, make):
    """Both engines' ids of one batch; ``make(package, i)`` gives row i's
    keyword arguments of SamplingParams."""
    outs = eng.generate(input_ids=prompts, sampling_params=[
        SamplingParams(**make("port", i)) for i in range(len(prompts))])
    jouts = jeng.generate(input_ids=prompts, sampling_params=[
        JaxSamplingParams(**make("jax", i)) for i in range(len(prompts))])
    return [o.output_ids for o in outs], [o.output_ids for o in jouts]


def test_engine_greedy_with_processors_matches_jax(engines):
    """Free greedy ids first; then one batch: rows 0 and 1 ban their own
    free ids, rows 2 and 3 share a boost processor (boost 1e4 and 0), rows
    4 and 5 take none. Equal to the JAX engine's ids; the banned ids never
    appear, boost 1e4 forces its token, the other rows keep their free
    ids; no processor row reaches a pipelined window, and the rows left
    after the processor rows finish do."""
    jeng, eng = engines
    runner = eng.scheduler.runner
    dispatched = []
    inner = runner.dispatch_decode_window

    def dispatch(wb, *a, **k):
        dispatched.append(wb.sampling_info.custom_processors)
        return inner(wb, *a, **k)

    runner.dispatch_decode_window = dispatch
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).tolist() for n in (7, 19, 12, 12, 23, 5)]
    new = [6, 6, 6, 6, 20, 20]
    free = lambda pkg, i: dict(temperature=0.0, max_new_tokens=new[i], ignore_eos=True)
    base, jbase = _generate(jeng, eng, prompts, free)
    assert base == jbase
    procs = {"port": (BannedTokensProcessor, ShiftByParam), "jax": (JaxBanned, JaxShiftByParam)}
    shift = {pkg: procs[pkg][1](77) for pkg in procs}

    def make(pkg, i):
        kw = free(pkg, i)
        if i < 2:
            kw["custom_logit_processor"] = procs[pkg][0](base[i])
        elif i < 4:
            kw.update(custom_logit_processor=shift[pkg], custom_params={"boost": 1e4 if i == 2 else 0.0})
        return kw

    eng.flush_cache()
    jeng.flush_cache()
    dispatched.clear()
    got, want = _generate(jeng, eng, prompts, make)
    runner.dispatch_decode_window = inner
    assert got == want
    assert not set(got[0]) & set(base[0]) and not set(got[1]) & set(base[1])
    assert got[2] == [77] * 6 and got[3] == base[3] and got[4:] == base[4:]
    assert dispatched and all(p is None for p in dispatched), dispatched
    eng.scheduler.check_memory_leak()


def test_penalties_across_a_decode_window_match_jax(engines):
    """Frequency, presence and repetition penalties on two rows beside a
    free one, 24 new tokens each (windows of 16 steps, the counts carried
    from step to step on the device): the JAX engine's ids."""
    jeng, eng = engines
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 500, n).tolist() for n in (9, 17, 4)]
    pens = [dict(frequency_penalty=0.8, presence_penalty=0.3), dict(repetition_penalty=1.5), {}]
    got, want = _generate(jeng, eng, prompts, lambda pkg, i: dict(
        temperature=0.0, max_new_tokens=24, ignore_eos=True, **pens[i]))
    assert eng.args.decode_window_size == 16
    assert got == want
    free, _ = _generate(jeng, eng, prompts[:2], lambda pkg, i: dict(
        temperature=0.0, max_new_tokens=24, ignore_eos=True))
    assert free != got[:2]  # the penalties change the ids
    eng.scheduler.check_memory_leak()
