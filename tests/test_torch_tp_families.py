"""Tensor parallelism for the dense text families beside Llama (Gemma 2,
Gemma 3 text, Phi-3, Apertus): the port's engine at tp 2 (two gloo
processes on the CPU) against the JAX package's engine at tp 2 and against
the port at tp 1.

- The JAX ``Engine(args, mesh=Mesh(devices[:2].reshape(1, 2), ("dp",
  "tp")), model_config=...)`` of each tiny family in f32, its norms (and
  Apertus's xIELU scalars) moved at random and placed again on the mesh by
  their own shardings; its weights go to the port through
  ``params_from_jax`` and each rank cuts its shard. The request set of
  ``test_torch_tp_engine.py`` (a chunked prompt, a radix hit, decode
  windows): the same greedy ids up to the first step whose top-2 margin is
  a near tie (``MARGIN``), the chosen logprobs within 1e-4 (2e-4 on 8-bit
  KV, ``LP_TOL``). Gemma 2 also on int8 KV. On every rank: two collectives a layer and forward plus the
  lookup's and the head's, and the same forwards and digests of sampled ids
  as the leader's.
- The port at tp 2 against the port at tp 1 on the same seeded random
  weights (each rank draws the tp 1 tensors and keeps its shard), Gemma 2,
  and Apertus with ``attention_backend="pallas"`` at tp 2 (row 9's wrapper
  on each rank's heads): the same greedy ids and logprobs within 1e-4;
  every rank's digests of its sampled ids and logprobs and of its gathered
  logits equal the leader's.

The MoE families are in ``test_torch_tp_moe.py``, which takes this file's
helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve

TP = 2
# chosen logprobs against the JAX engine: f32 to its rounding; on 8-bit KV
# each engine quantizes its own K/V rows, and a row within f32 rounding of a
# code's midpoint takes two codes (tiny Mixtral's int8 radix-hit request
# read 1.03e-4 at 1e-4), so the 8-bit cases take the 8-bit KV tests' 2e-4
# (test_torch_kv_quant.TOL)
LP_TOL = {"auto": 1e-4, "int8": 2e-4}
# each family's leaves that the random init leaves at one or zero, moved by
# this many N(0, 1) (norms: every name ending in "norm")
MOVED = {"bq": 0.1, "bk": 0.1, "bv": 0.1, "bo": 0.1, "router_b": 0.1, "gate_up_b": 0.1, "down_b": 0.1,
         "sinks": 2.0, "alpha_p": 0.5, "alpha_n": 0.5, "router_bias": 0.1}
# tiny configs, one HF-style dict a family for both packages (Gemma 3: a
# global layer every second one, its global rope base apart from the
# local 10,000; windows of 16 tokens against prompts of 40)
GEMMA2 = dict(
    architectures=["Gemma2ForCausalLM"], vocab_size=512, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
    max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0, query_pre_attn_scalar=32,
    sliding_window=16, attn_logit_softcapping=50.0, final_logit_softcapping=30.0, tie_word_embeddings=True,
)
GEMMA3 = dict(GEMMA2, architectures=["Gemma3ForCausalLM"], rope_theta=1_000_000.0, sliding_window_pattern=2,
              attn_logit_softcapping=None, final_logit_softcapping=None)
LLAMA_LIKE = dict(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False,
)
DENSE = {
    "gemma2": GEMMA2,
    "gemma3": GEMMA3,
    "phi3": dict(LLAMA_LIKE, architectures=["Phi3ForCausalLM"]),
    "apertus": dict(LLAMA_LIKE, architectures=["ApertusForCausalLM"]),
}


def configs(hf: dict) -> tuple:
    """The JAX and the port config of one HF-style dict, in f32."""
    return JaxModelConfig.from_hf_config(hf, dtype="float32"), ModelConfig.from_hf_config(hf, dtype="float32")


def perturbed(tree, seed: int):
    """A JAX pytree (numpy leaves; dicts and lists) in f32 with every norm
    moved by 0.1 N(0, 1) and each ``MOVED`` leaf by its share of N(0, 1):
    the random init leaves them at one or zero, which would hide one that a
    rank adds on every rank, drops or misplaces."""
    rng = np.random.default_rng(seed)

    def walk(name, a):
        if isinstance(a, dict):
            return {k: walk(k, v) for k, v in a.items()}
        if isinstance(a, list):
            return [walk(name, v) for v in a]
        a = np.asarray(a, np.float32)
        std = 0.1 if name.endswith("norm") else MOVED.get(name, 0.0)
        return a + std * rng.normal(size=a.shape).astype(np.float32) if std else a

    return walk("", tree)


def jax_tp2_engine(hf: dict, kv: str = "auto"):
    """The JAX engine of ``hf`` on a two-device CPU mesh, its weights
    perturbed and placed again on the mesh by their own shardings; and the
    port's state of the same weights (``params_from_jax``)."""
    jcfg, cfg = configs(hf)
    mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("dp", "tp"))
    jeng = JaxEngine(JaxServerArgs(**ARGS, kv_cache_dtype=kv, warmup_capture=False), mesh=mesh, model_config=jcfg)
    runner = jeng.scheduler.runner
    host = perturbed(jax.tree.map(np.asarray, runner.params), seed=2)
    runner.params = jax.tree.map(lambda new, old: jax.device_put(jnp.asarray(new, old.dtype), old.sharding),
                                 host, runner.params)
    state = params_from_jax(host, cfg, transposed=getattr(runner.model, "weights_transposed", False))
    return jeng, cfg, state


def rank_reports(eng, per_layer: int = 2) -> list:
    """Every rank's ``tp_report`` since ``reset_counts``, held to the
    leader's: ``per_layer`` collectives a layer and forward plus the
    lookup's and the head's, the same forwards, sampled ids and logprobs
    and router picks (MoE)."""
    runner = eng.scheduler.runner
    reports = [runner.tp_report()] + runner.follower_reports()
    n = sum(reports[0]["forwards"].values())
    L = eng.model_config.num_hidden_layers
    for rep in reports:
        assert rep["collectives"] == (per_layer * L + 2) * n > 0, (rep["rank"], rep["collectives"], n)
        for key in ("forwards", "tokens_sampled", "token_digest", "router_picks", "router_digest"):
            assert rep[key] == reports[0][key], (rep["rank"], key)
    return reports


def matches_the_jax_engine(hf: dict, kv: str, per_layer: int = 2) -> list:
    """``hf``'s port engine at tp 2 against the JAX engine at tp 2 on the
    same weights (``jax_tp2_engine``): the greedy ids up to a near tie, the
    chosen logprobs within 1e-4, at least 30 of the 47 tokens compared; the
    ranks' reports (``rank_reports``)."""
    jeng, cfg, state = jax_tp2_engine(hf, kv)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, **ARGS, kv_cache_dtype=kv), model_config=cfg, params=state)
    try:
        eng.scheduler.runner.reset_counts()  # every rank's
        prompts, outs = _serve(eng, SamplingParams)
        reports = rank_reports(eng, per_layer)
        _, jouts = _serve(jeng, JaxSamplingParams)
        assert outs[-1].cached_tokens == jouts[-1].cached_tokens == 32
        assert _compare(prompts, outs, jouts, eng, stop_at_tie=True, lp_tol=LP_TOL[kv]) >= 30  # of 47
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
    return reports


@pytest.mark.parametrize(
    "family, kv",
    [("gemma2", "auto"), ("gemma2", "int8"), ("gemma3", "auto"), ("phi3", "auto"), ("apertus", "auto")],
    ids=["gemma2", "gemma2-int8", "gemma3", "phi3", "apertus"],
)
def test_tp2_matches_the_jax_engine_at_tp2(family, kv):
    reports = matches_the_jax_engine(DENSE[family], kv)
    Hkv = DENSE[family]["num_key_value_heads"]
    assert all(rep["kv_heads"] == Hkv // TP for rep in reports)
    assert reports[0]["router_digest"] is None  # no router


@pytest.mark.parametrize("family, backend", [("gemma2", "auto"), ("apertus", "pallas")],
                         ids=["gemma2", "apertus-pallas"])
def test_tp2_matches_tp1_and_every_rank_agrees(family, backend):
    """One family on the same seeded weights at tp 1 (``auto``) and tp 2
    (``backend``; ``pallas`` decodes through ``decode_attention_pallas`` on
    each rank's heads): greedy ids and logprobs; every rank's digests of its
    sampled ids and logprobs and of its gathered logits (``forward_logits``
    of the margins) equal the leader's."""
    ref = Engine(ServerArgs(device="cpu", **ARGS), model_config=configs(DENSE[family])[1])
    prompts, ref_outs = _serve(ref, SamplingParams)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, attention_backend=backend, **ARGS),
                 model_config=configs(DENSE[family])[1])
    try:
        runner = eng.scheduler.runner
        assert runner.model.decode_attention.__name__ == {"auto": "decode_attention_gqa_tp",
                                                          "pallas": "decode_attention_pallas_tp"}[backend]
        runner.reset_counts()
        _, outs = _serve(eng, SamplingParams)
        rank_reports(eng)
        assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=False) == 47
        digests = [runner.tp_report()] + runner.follower_reports()
        assert digests[0]["logits_digest"] == digests[1]["logits_digest"]
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
