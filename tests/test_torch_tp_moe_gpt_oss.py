"""Tensor parallelism for GPT-OSS: the port's engine at tp 2 against the JAX
engine at tp 2, its experts whole on every rank (``test_torch_tp_moe.py``'s
cases and helpers, one family a file).
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_tp_moe import matches_at_tp2


@pytest.mark.parametrize("family, kv", [("gpt-oss", "auto")], ids=["gpt-oss"])
def test_tp2_matches_the_jax_engine_at_tp2(family, kv):
    matches_at_tp2(family, kv)
