"""Quantized weights under tensor parallelism, GPT-OSS: q, k and v (and
their biases) cut by column, o by row with its bias added once after the
sum, the 4-bit experts whole on every rank (rows 6 and 7 at their groups
of 64 and 48 here, 120 at GPT-OSS-20B's widths). The port's engine at tp
2 (two gloo processes on the CPU) as ``test_torch_tp_quant.py`` holds the
Llama family (its helpers).

- W4A8 (W4A16 in ``test_torch_tp_quant_gpt_oss_w4a16.py``) against the
  JAX engine at tp 2 on its own codes: the same greedy ids up to a near
  tie, the chosen logprobs within 1e-4; 2 collectives a layer and forward
  (o's row maximum and sum; W4A16 1) plus the lookup's and the head's;
  every rank's router picks and sampled ids the leader's.
- fp8: the JAX engine raises at every tp (its GPT-OSS ``_moe`` hands the
  experts' ``Fp8Linear`` to the 4-bit matmul, ``gpt_oss.py:234``; ROADMAP
  Queue 3), so the port at tp 2 is held to the port at tp 1 on the same
  seeded weights.
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
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve
from test_torch_tp_families import LP_TOL, TP, configs, rank_reports
from test_torch_tp_moe import GPT_OSS
from test_torch_tp_quant import jax_tp2_quant_engine


def matches_at_tp2(quantization: str, per_layer: int) -> None:
    """GPT-OSS with ``quantization`` at tp 2 against the JAX engine at tp 2
    on its codes: the experts whole, o's share, ids, logprobs, each rank's
    collectives and router picks."""
    jeng, cfg, state = jax_tp2_quant_engine(GPT_OSS, quantization)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, quantization=quantization, **ARGS), model_config=cfg,
                 params=state)
    try:
        layer = eng.scheduler.runner.model.layers[0]
        assert len(layer.gate_up) == GPT_OSS["num_local_experts"] and layer.gate_up[0].group_size == 64
        assert layer.down[0].group_size == 48 and layer.wo.in_features == 64  # experts whole, o's share
        eng.scheduler.runner.reset_counts()
        prompts, outs = _serve(eng, SamplingParams)
        reports = rank_reports(eng, per_layer)
        assert reports[0]["router_picks"] > 0
        _, jouts = _serve(jeng, JaxSamplingParams)
        assert _compare(prompts, outs, jouts, eng, stop_at_tie=True, lp_tol=LP_TOL["auto"]) >= 30  # of 47
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("quantization, per_layer", [("w4a8", 2)], ids=["w4a8"])
def test_tp2_matches_the_jax_engine_at_tp2(quantization, per_layer):
    matches_at_tp2(quantization, per_layer)


def test_fp8_at_tp2_matches_tp1_where_the_jax_engine_raises():
    jcfg, cfg = configs(GPT_OSS)
    mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("dp", "tp"))
    jeng = JaxEngine(JaxServerArgs(**ARGS, quantization="fp8", warmup_capture=False), mesh=mesh,
                     model_config=jcfg)
    with pytest.raises(AttributeError, match="'Fp8Linear' object has no attribute 'q'"):
        jeng.generate(input_ids=[[5, 6, 7]], sampling_params=JaxSamplingParams(temperature=0.0, max_new_tokens=2))
    ref = Engine(ServerArgs(device="cpu", quantization="fp8", **ARGS), model_config=configs(GPT_OSS)[1])
    prompts, ref_outs = _serve(ref, SamplingParams)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, quantization="fp8", **ARGS), model_config=cfg)
    try:
        eng.scheduler.runner.reset_counts()
        _, outs = _serve(eng, SamplingParams)
        assert rank_reports(eng, 1)[0]["router_picks"] > 0
        assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=True) >= 30
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
