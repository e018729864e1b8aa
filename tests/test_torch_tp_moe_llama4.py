"""Tensor parallelism for Llama-4 text: the port's engine at tp 2 against the
JAX engine at tp 2 and against the port at tp 1 (``test_torch_tp_moe.py``'s
cases and helpers, one family a file).
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS
from test_torch_tp_engine import _compare, _serve
from test_torch_tp_families import TP, configs, rank_reports
from test_torch_tp_moe import LLAMA4, matches_at_tp2


@pytest.mark.parametrize("family, kv", [("llama4", "auto")], ids=["llama4"])
def test_tp2_matches_the_jax_engine_at_tp2(family, kv):
    matches_at_tp2(family, kv)


def test_tp2_matches_tp1_and_every_rank_agrees():
    """Llama-4 on the same seeded weights at tp 1 and tp 2: greedy ids and
    logprobs; every rank's digests of its router picks, sampled ids and
    logprobs and gathered logits equal the leader's."""
    ref = Engine(ServerArgs(device="cpu", **ARGS), model_config=configs(LLAMA4)[1])
    prompts, ref_outs = _serve(ref, SamplingParams)
    eng = Engine(ServerArgs(device="cpu", tp_size=TP, **ARGS), model_config=configs(LLAMA4)[1])
    try:
        runner = eng.scheduler.runner
        runner.reset_counts()
        _, outs = _serve(eng, SamplingParams)
        assert rank_reports(eng)[0]["router_picks"] > 0
        assert _compare(prompts, outs, ref_outs, eng, stop_at_tie=False) == 47
        digests = [runner.tp_report()] + runner.follower_reports()
        assert digests[0]["logits_digest"] == digests[1]["logits_digest"]
        eng.scheduler.check_memory_leak()
    finally:
        eng.shutdown()
