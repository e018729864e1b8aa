"""Quantized weights under tensor parallelism, Mixtral: the port's engine
at tp 2 (two gloo processes on the CPU) against the JAX package's engine
at tp 2 on its own codes, as ``test_torch_tp_quant.py`` holds the Llama
family (its helpers); Qwen3-MoE is in ``test_torch_tp_quant_qwen3_moe.py``.

- W4A8 and W4A16 (fp8 is in ``test_torch_tp_quant_fp8.py``): each
  expert's w1 and w3 cut by Out, w2 by In; under W4A8 w2's quantizer takes
  the whole rows' maxima of every expert's activations in one collective a
  layer, so 4 collectives a layer and forward (o's maximum and sum, the
  experts' maximum and sum), under W4A16 2, plus the lookup's and the
  head's. The same greedy ids up to a near tie, the chosen logprobs within
  1e-4; every rank's router picks, forwards and sampled ids the leader's.
- A rank's streamed load of Mixtral (each expert drawn whole, quantized,
  cut) equals the cut of the tp 1 engine's codes, for W4A8 and fp8.
"""

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import shard_state, w4_real_widths
from scratchpad_tpu_torch.models.mixtral import MixtralForCausalLM
from scratchpad_tpu_torch.parallel import TPGroup
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve
from test_torch_tp_families import LLAMA_LIKE, LP_TOL, TP, rank_reports
from test_torch_tp_quant import PER_LAYER, jax_tp2_quant_engine

# each expert's width 256: 128 a rank, whole groups of 128
MIXTRAL = dict(LLAMA_LIKE, architectures=["MixtralForCausalLM"], intermediate_size=256, num_local_experts=4,
               num_experts_per_tok=2)


def matches_at_tp2(hf: dict, quantization: str) -> None:
    """``hf`` with ``quantization`` at tp 2 against the JAX engine at tp 2
    on its codes: ids, logprobs, each rank's collectives and router
    picks."""
    jeng, cfg, state = jax_tp2_quant_engine(hf, quantization)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, quantization=quantization, **ARGS), model_config=cfg,
                 params=state)
    try:
        eng.scheduler.runner.reset_counts()
        prompts, outs = _serve(eng, SamplingParams)
        reports = rank_reports(eng, PER_LAYER[quantization])
        assert reports[0]["router_picks"] > 0  # the same picks on every rank (rank_reports)
        _, jouts = _serve(jeng, JaxSamplingParams)
        assert _compare(prompts, outs, jouts, eng, stop_at_tie=True, lp_tol=LP_TOL["auto"]) >= 30  # of 47
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("quantization", ["w4a8", "w4a16"])
def test_tp2_matches_the_jax_engine_at_tp2(quantization):
    matches_at_tp2(MIXTRAL, quantization)


def _mixtral_rank(cfg, quantization, rank):
    """Rank ``rank``'s Mixtral at tp 2, each whole tensor of the tp 1
    stream of seed 0 placed (an expert at a time)."""
    group = TPGroup(rank=rank, size=TP, device=torch.device("cpu"), backend="gloo", ranks_on_device=TP)
    model = MixtralForCausalLM(cfg, "cpu", torch.float32, quantization=quantization, tp=group)
    model.reset_constants_()
    twin = MixtralForCausalLM(cfg, torch.device("meta"), torch.float32)
    twin.init_random_(torch.Generator().manual_seed(0),
                      place=lambda name, whole, e=None: model.place_whole(name, whole, None, e))
    return model


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("quantization", ["w4a8", "fp8"])
def test_streamed_rank_load_is_the_cut_of_the_tp1_codes(quantization):
    cfg = ModelConfig.from_hf_config(MIXTRAL, dtype="float32")
    dense = MixtralForCausalLM(cfg, "cpu", torch.float32)
    dense.init_random_(torch.Generator().manual_seed(0))
    one = MixtralForCausalLM(cfg, "cpu", torch.float32, quantization=quantization).quantize_state(
        dense.state_dict())
    for r in range(TP):
        model = _mixtral_rank(cfg, quantization, r)
        got, want = model.state_dict(), shard_state(one, r, TP, "mixtral", w4_real_widths(model, TP))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), k
        if quantization == "w4a8":  # w1 by Out, w2 by In (its bytes and its groups)
            assert got["layers.0.w1.3.q"].shape == (128, 64) and got["layers.0.w2.3.q"].shape == (128, 64)
            assert got["layers.0.w2.3.s"].shape == (1, 128)
        else:  # w2's scales whole on every rank
            assert got["layers.0.w2.w8"].shape == (4, 128, 128) and torch.equal(got["layers.0.w2.s"],
                                                                               one["layers.0.w2.s"])
