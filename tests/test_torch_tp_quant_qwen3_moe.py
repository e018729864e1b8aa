"""Quantized weights under tensor parallelism, Qwen3-MoE (qk-norm, the
renormalised top-k): the port's engine at tp 2 (two gloo processes on the
CPU) as ``test_torch_tp_quant_moe.py`` holds Mixtral (its helpers).

- W4A16 against the JAX engine at tp 2 on its own codes (fp8 is in
  ``test_torch_tp_quant_fp8.py``): the same greedy ids up to a near tie,
  the chosen logprobs within 1e-4; 2 collectives a layer and forward plus
  the lookup's and the head's.
- W4A8 against the JAX engine at tp 2 through the int8 ties, as
  ``test_torch_tp_quant.py`` holds Llama W4A8 (``held_at_ties``): one
  element of the radix hit's decode input to the experts lies at a half
  (7.499998 in the JAX engine, 7.500001 in the port), whose code a step
  apart moves a chosen logprob by 1.35e-2 downstream; with the JAX
  engine's code there the port at tp 1 holds it within 1e-4. The port at
  tp 2 holds the port at tp 1 within 1e-4 (4 collectives a layer).
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve
from test_torch_tp_families import LLAMA_LIKE, TP, configs, rank_reports
from test_torch_tp_quant import JaxQuantizerInputs, held_at_ties, jax_tp2_quant_engine
from test_torch_tp_quant_moe import matches_at_tp2

# each expert's width 256: 128 a rank, whole groups of 128
QWEN3_MOE = dict(LLAMA_LIKE, architectures=["Qwen3MoeForCausalLM"], num_experts=4, num_experts_per_tok=2,
                 moe_intermediate_size=256, norm_topk_prob=True, decoder_sparse_step=1)


@pytest.mark.parametrize("quantization", ["w4a16"])
def test_tp2_matches_the_jax_engine_at_tp2(quantization):
    matches_at_tp2(QWEN3_MOE, quantization)


def test_w4a8_at_tp2_matches_tp1(monkeypatch):
    """The port at tp 2 against the port at tp 1 on the JAX engine's codes,
    and the port at tp 1 against the JAX engine at tp 2 at its ties."""
    jax_inputs = JaxQuantizerInputs(monkeypatch)
    jeng, cfg, state = jax_tp2_quant_engine(QWEN3_MOE, "w4a8")
    ref = Engine(ServerArgs(device="cpu", quantization="w4a8", **ARGS), model_config=configs(QWEN3_MOE)[1],
                 params=state)
    prompts, ref_outs = _serve(ref, SamplingParams)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, quantization="w4a8", **ARGS), model_config=cfg, params=state)
    try:
        eng.scheduler.runner.reset_counts()
        _, outs = _serve(eng, SamplingParams)
        assert rank_reports(eng, 4)[0]["router_picks"] > 0
        assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=True) >= 30
        # the JAX engine's calls a layer: q, k, v, o, then w1, w3, w2 an expert
        E = QWEN3_MOE["num_experts"]
        held_at_ties(QWEN3_MOE, state, jax_inputs.serve(jeng), jax_inputs.calls(4 + 3 * E, cfg.num_hidden_layers))
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
