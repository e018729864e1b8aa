"""fp8 weights under tensor parallelism, Mixtral and Qwen3-MoE: the port's
engine at tp 2 (two gloo processes on the CPU) against the JAX package's
engine at tp 2 on its own codes (``test_torch_tp_quant_moe.py``'s helper):
q, k, v and each expert's w1 and w3 cut by Out with their scales, o and w2
by In with each column's scale whole on every rank, w2's partial products
f32 until the experts' sum; the same greedy ids up to a near tie, the
chosen logprobs within 1e-4, 2 collectives a layer and forward plus the
lookup's and the head's, every rank's router picks the leader's.
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_tp_quant_moe import MIXTRAL, matches_at_tp2
from test_torch_tp_quant_qwen3_moe import QWEN3_MOE


@pytest.mark.parametrize("hf", [MIXTRAL, QWEN3_MOE], ids=["mixtral", "qwen3-moe"])
def test_tp2_matches_the_jax_engine_at_tp2(hf):
    matches_at_tp2(hf, "fp8")
