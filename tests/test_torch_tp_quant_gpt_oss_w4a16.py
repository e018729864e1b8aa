"""W4A16 weights under tensor parallelism, GPT-OSS: the port's engine at tp
2 (two gloo processes on the CPU) against the JAX package's engine at tp 2
on its own codes (``test_torch_tp_quant_gpt_oss.py``'s helper): the experts
whole on every rank (row 7 at their groups), o by row (row 5), 1
collective a layer and forward plus the lookup's and the head's.
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_tp_quant_gpt_oss import matches_at_tp2


@pytest.mark.parametrize("quantization, per_layer", [("w4a16", 1)], ids=["w4a16"])
def test_tp2_matches_the_jax_engine_at_tp2(quantization, per_layer):
    matches_at_tp2(quantization, per_layer)
