"""Greedy ids of the port's Llama-4 engine against the JAX engine's, on the
CPU in f32, in both layer layouts of ``tests/test_torch_llama4.py`` ("maverick",
dense and MoE layers in turn; "scout", every layer MoE): the same perturbed
weights through ``params_from_jax``, chunked prefill (chunks of 16) and a
radix hit; equal, with the port's top-2 margin above 1e-3 at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_llama4 import LAYOUTS, configs, perturbed
from test_torch_moe import ENGINE_ARGS, greedy_match


def engines(layout):
    """A JAX engine and a port engine (CPU) on the same perturbed weights,
    prefilling 16 tokens at a time."""
    jcfg, cfg = configs(layout)
    jeng = JaxEngine(JaxServerArgs(**ENGINE_ARGS, warmup_capture=False), model_config=jcfg)
    jrunner = jeng.scheduler.runner
    params = perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    eng = Engine(ServerArgs(device="cpu", **ENGINE_ARGS), model_config=cfg)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_greedy_matches_jax(layout):
    """Prompts of 21 and 40 tokens (past two chunks of 8 and the NoPE
    floor of 8) in chunks of 16, decodes of 10 tokens across further chunk
    edges, then a radix hit on the second prompt's first 36 tokens."""
    jeng, eng = engines(layout)
    runner = eng.scheduler.runner
    assert type(runner.model).__name__ == "Llama4ForCausalLM" and runner.attention_backend == "auto"
    rng = np.random.default_rng(61)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 40)]
    again = prompts[1][:36] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)
