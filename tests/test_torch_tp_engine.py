"""The port's engine at tp 2 (two gloo processes on the CPU) against the JAX
package's engine at tp 2 and against the port at tp 1.

- The JAX ``Engine(args, mesh=Mesh(devices[:2].reshape(1, 2), ("dp", "tp")))``
  on tiny-debug in f32, as ``tests/test_tp.py:13-52`` builds it, on model-
  dtype, int8 and fp8 KV; its weights go to the port through
  ``params_from_jax`` and each rank cuts its shard. The request set of
  ``test_torch_engine.py`` (a chunked prompt, a radix hit, decode windows):
  the same greedy ids up to the first step whose top-2 margin is a near tie
  (``MARGIN``), and the chosen logprobs within 1e-4.
- The port at tp 2 against the port at tp 1 on the same seeded random
  weights (each rank draws the tp 1 tensors and keeps its shard): the same
  greedy ids and logprobs within 1e-4, embeddings and teacher-forced scores
  within 1e-5; every rank's sampled ids and logprobs bit-equal in sampled,
  pipelined windows.

The faults, the refusals of a live engine and ``sp serve --tp-size 2`` are
in ``test_torch_tp.py``.
"""


import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS, MARGIN, _prompt, _teacher_forced_margins

LP_TOL = 1e-4


def _requests():
    """test_torch_engine's set: 5, 23 and 40 tokens (40 > the chunk of 16),
    then a radix hit on the 40-token prompt."""
    prompts = [_prompt(n, seed=n) for n in (5, 23, 40)]
    again = prompts[2][:32] + _prompt(6, seed=99)
    return prompts, [12, 9, 16], again


def _serve(eng, sp_cls):
    prompts, max_new, again = _requests()
    outs = eng.generate(input_ids=prompts, return_logprob=True,
                        sampling_params=[sp_cls(temperature=0.0, max_new_tokens=m) for m in max_new])
    outs.append(eng.generate(input_ids=again, return_logprob=True,
                             sampling_params=sp_cls(temperature=0.0, max_new_tokens=10)))
    return prompts + [again], outs


def _tp_engine(args=None, **kw) -> Engine:
    """A tp 2 engine on the CPU at ``ARGS`` and ``args``; ``kw``: Engine's."""
    return Engine(ServerArgs(device="cpu", tp_size=2, **ARGS, **(args or {})), **kw)


def _compare(prompts, outs, ref_outs, eng, stop_at_tie: bool, lp_tol: float = LP_TOL) -> int:
    """The same ids up to the first near tie of ``eng``'s teacher-forced
    margins (all of them unless ``stop_at_tie``), chosen logprobs within
    ``lp_tol``; returns the tokens compared."""
    compared = 0
    for p, o, r in zip(prompts, outs, ref_outs):
        assert len(o.output_ids) == len(r.output_ids)
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids
        n = len(o.output_ids)
        if stop_at_tie:
            n = next((i for i, g in enumerate(margins) if g <= MARGIN), n)
        else:
            assert min(margins) > MARGIN, min(margins)
        assert o.output_ids[:n] == r.output_ids[:n]
        np.testing.assert_allclose(o.output_token_logprobs[:n], r.output_token_logprobs[:n], rtol=0, atol=lp_tol)
        compared += n
    return compared


@pytest.mark.parametrize("kv", ["auto", "int8", "fp8"], ids=["model-dtype-kv", "int8", "fp8"])
def test_tp2_matches_the_jax_engine_at_tp2(kv):
    devs = jax.devices()
    mesh = Mesh(np.array(devs[:2]).reshape(1, 2), ("dp", "tp"))
    jeng = JaxEngine(JaxServerArgs(**ARGS, kv_cache_dtype=kv), mesh=mesh)
    runner = jeng.scheduler.runner
    state = params_from_jax(jax.tree.map(np.asarray, runner.params), get_preset("tiny-debug"),
                            transposed=getattr(runner.model, "weights_transposed", False))
    eng = _tp_engine(args=dict(kv_cache_dtype=kv), params=state)
    try:
        assert eng.scheduler.runner.kv_cache.num_kv_heads == 1  # Hkv 2 over 2 ranks
        prompts, outs = _serve(eng, SamplingParams)
        _, jouts = _serve(jeng, JaxSamplingParams)
        assert outs[-1].cached_tokens == jouts[-1].cached_tokens == 32
        assert _compare(prompts, outs, jouts, eng, stop_at_tie=kv != "auto") >= 30  # of 47
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()


def test_tp2_matches_tp1_and_every_rank_samples_alike():
    """The same seeded weights at tp 1 and tp 2: greedy ids and logprobs,
    embeddings and scores; then sampled requests in pipelined windows, each
    chained on the device, after which every rank's digest of its sampled
    ids and logprobs equals the leader's."""
    ref = Engine(ServerArgs(device="cpu", **ARGS))
    prompts, ref_outs = _serve(ref, SamplingParams)
    ref_emb = np.asarray(ref.encode(input_ids=prompts[:2]))
    ref_score = ref.score(prompts[2])
    eng = _tp_engine(args=dict(enable_overlap=True, decode_window_size=4))
    try:
        runner = eng.scheduler.runner
        _, outs = _serve(eng, SamplingParams)
        assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=False) == 47
        np.testing.assert_allclose(np.asarray(eng.encode(input_ids=prompts[:2])), ref_emb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(eng.score(prompts[2]), ref_score, rtol=0, atol=1e-5)
        chained = []
        inner = runner.dispatch_decode_window

        def spy(wb, K, prev_tokens=None):
            chained.append(prev_tokens is not None)
            return inner(wb, K, prev_tokens)

        runner.dispatch_decode_window = spy
        runner.reset_counts()  # every rank's
        sampled = eng.generate(input_ids=prompts, sampling_params=[
            SamplingParams(temperature=1.0, top_p=0.9, max_new_tokens=24, ignore_eos=True)] * 3)
        assert all(len(o.output_ids) == 24 for o in sampled) and any(chained)
        mine, (theirs,) = runner.tp_report(), runner.follower_reports()
        assert mine["tokens_sampled"] == theirs["tokens_sampled"] > 3 * 24
        assert mine["token_digest"] == theirs["token_digest"]
        assert mine["logits_digest"] == theirs["logits_digest"]  # the gathered logits
        assert mine["forwards"] == theirs["forwards"]
        n = sum(mine["forwards"].values())
        # o's and down's sums in each of 2 layers, the lookup's, the head's
        assert mine["collectives"] == theirs["collectives"] == (2 * 2 + 2) * n > 0
        assert (mine["rank"], theirs["rank"]) == (0, 1) and theirs["kv_heads"] == 1
        # the follower imports neither JAX nor what the card's machine lacks
        assert not {"jax", "jaxlib", "scratchpad_tpu", "aiohttp", "pydantic"} & set(theirs["packages"])
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
    assert not eng._followers
