"""Tensor parallelism for DeepSeek-V2 and V3: the port's engine at tp 2 against
the JAX engine at tp 2, the whole latent pool on every rank
(``test_torch_tp_moe.py``'s cases and helpers, one family a file).
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_tp_moe import matches_at_tp2


@pytest.mark.parametrize("family, kv", [("deepseek-v2", "auto"), ("deepseek-v3", "auto")],
                         ids=["deepseek-v2", "deepseek-v3"])
def test_tp2_matches_the_jax_engine_at_tp2(family, kv):
    matches_at_tp2(family, kv)
