"""Greedy ids of the port's DeepSeek engine against the JAX engine's, on the
CPU in f32 (the tiny config of ``tests/test_torch_deepseek.py`` with
``q_lora_rank``): chunked prefill, a radix hit on the latent pool, the
port's decode windows pipelined; then both engines' embeddings and
teacher-forced scores.
"""

import jax
import jax.numpy as jnp
import numpy as np

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_deepseek import ENGINE_ARGS, LATENT, configs, perturbed
from test_torch_moe import greedy_match
import torch_threads  # noqa: F401  (one torch thread a test process)


def test_engine_greedy_matches_jax():
    """V2 with ``q_lora_rank`` (the JAX package's own engine test's model),
    perturbed: prompts of 19, 7 and 26 tokens in chunks of 8, decodes of
    10, then a radix hit on the latent pool; the port's decode windows
    pipelined (``enable_overlap``); no page leaks; then embeddings and
    teacher-forced scores of both engines."""
    jcfg, cfg = configs(q_lora_rank=24)
    jeng = JaxEngine(JaxServerArgs(**ENGINE_ARGS, warmup_capture=False), model_config=jcfg)
    jrunner = jeng.scheduler.runner
    assert jrunner.kv_config.mla
    params = perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    eng = Engine(ServerArgs(device="cpu", enable_overlap=True, **ENGINE_ARGS), model_config=cfg)
    runner = eng.scheduler.runner
    runner.model.load_state_dict(params_from_jax(params, cfg))
    assert runner.kv_cache.mla and runner.kv_cache.k.shape[-2:] == (1, LATENT)
    assert runner.kv_cache_dtype == "float32" and eng.scheduler.overlap_enabled()
    dispatched = []
    inner = runner.dispatch_decode_window
    runner.dispatch_decode_window = lambda *a, **k: dispatched.append(1) or inner(*a, **k)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, n).tolist() for n in (19, 7, 26)]
    again = prompts[2][:24] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)
    assert dispatched, "no decode window was pipelined"
    # the hidden-state captures: embeddings and teacher-forced scores
    np.testing.assert_allclose(np.asarray(eng.encode(input_ids=prompts[0])),
                               np.asarray(jeng.encode(input_ids=prompts[0])), atol=1e-5)
    np.testing.assert_allclose(eng.score(prompts[2]), jeng.score(prompts[2]), atol=1e-4)
