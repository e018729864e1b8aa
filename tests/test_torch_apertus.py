"""The port's Apertus against the JAX package's, on the CPU in f32, and
against HF transformers' ``ApertusForCausalLM`` on the same random weights.

- Logits of extend steps (fresh prompts, a chunk after a cached prefix) and
  teacher-forced decode steps, both sides built from one seeded JAX pytree
  (stacked layers) through ``params_from_jax``, its norms moved by 0.1
  N(0, 1) and its xIELU scalars by 0.5 N(0, 1) (the init leaves them at one
  and 0.8), under ``attention_backend`` ``auto`` and ``pallas``. Tolerance
  1e-4, ``tests/test_torch_model.py``'s.
- Greedy ids of a port engine against the JAX engine's on the same weights,
  through chunked prefill and a radix hit: equal, with the port's top-2
  margin above 1e-3 at every step.
- HF's model on its random weights (norms moved) carried into the port
  through ``convert_hf_state``: every prompt position's logits within 1e-4;
  the port's conversion equals ``params_from_jax`` of the JAX package's.
- Quantization and toppings are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.apertus import xielu
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_model import PS, TOL, Pair, _extend_and_decode
from test_torch_moe import ENGINE_ARGS, greedy_match
from test_torch_qwen import hf_random, port_from_hf, prompt_logits

HF_APERTUS = dict(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=1024,
    rms_norm_eps=1e-5, rope_theta=12000000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    tie_word_embeddings=False,
)
TINY = dict(HF_APERTUS, architectures=["ApertusForCausalLM"])


def perturbed(params: dict, seed: int) -> dict:
    """The pytree (numpy, f32) with every norm moved by 0.1 N(0, 1) and the
    xIELU scalars by 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def move(name, a):
        a = np.asarray(a, np.float32)
        scale = 0.1 if name.endswith("norm") else 0.5 if name.startswith("alpha") else 0.0
        return a + scale * rng.normal(size=a.shape).astype(np.float32)

    out = {k: move(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: move(k, v) for k, v in params["layers"].items()}
    return out


class ApertusPair(Pair):
    def __init__(self, backend, num_pages=64):
        self.jcfg = JaxModelConfig.from_hf_config(TINY, dtype="float32")
        self.cfg = ModelConfig.from_hf_config(TINY, dtype="float32")
        self.jmodel = jax_get_model_class("ApertusForCausalLM")(self.jcfg)
        self.jmodel.page_size = PS
        params = perturbed(jax.tree.map(np.asarray, self.jmodel.init_params(
            jax.random.PRNGKey(0), jnp.float32)), seed=1)
        self.params = jax.tree.map(jnp.asarray, params)
        self.model = get_model_class("ApertusForCausalLM")(self.cfg, torch.device("cpu"), torch.float32)
        self.model.load_state_dict(params_from_jax(params, self.cfg))
        self.model.decode_attention, self.model.extend_attention = attention_functions(backend)
        L, Hkv, D = self.cfg.num_hidden_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        self.jkv = jax_create_kv_cache(JaxKVConfig(
            num_layers=L, num_pages=num_pages, page_size=PS, num_kv_heads=Hkv, head_dim=D,
            dtype=jnp.float32,
        ))
        self.kv = create_kv_cache(KVCacheConfig(L, num_pages, PS, Hkv, D, torch.float32),
                                  torch.device("cpu"))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_logits_match_jax(backend):
    pair = ApertusPair(backend)
    assert pair.model.layers[1].alpha_p.dtype == torch.float32
    _extend_and_decode(pair, TOL)


def test_xielu_matches_jax():
    """xIELU on both sides of zero and at the eps clamp: f32 within 1e-6 +
    1e-5 |x| (the two libraries' expm1 and softplus), bf16 within an ulp."""
    from scratchpad_tpu.models.apertus import xielu as jax_xielu

    x = np.concatenate([np.linspace(-8, 8, 1001), [0.0, -1e-7, -1e-6, -2e-6, 1e-7]]).astype(np.float32)
    for ap, an in ((0.8, 0.8), (-1.3, 2.1)):
        a, b = np.float32([ap]), np.float32([an])
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            ours = xielu(torch.from_numpy(x).to(dt), torch.from_numpy(a), torch.from_numpy(b)).float().numpy()
            theirs = np.asarray(jax_xielu(jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(b)), np.float32)
            np.testing.assert_allclose(ours, theirs, rtol=1e-5 if dt == torch.float32 else 1e-2, atol=1e-6)


def test_engine_greedy_matches_jax():
    jcfg = JaxModelConfig.from_hf_config(TINY, dtype="float32")
    jeng = JaxEngine(JaxServerArgs(**ENGINE_ARGS, warmup_capture=False), model_config=jcfg)
    jrunner = jeng.scheduler.runner
    params = perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    eng = Engine(ServerArgs(device="cpu", **ENGINE_ARGS),
                 model_config=ModelConfig.from_hf_config(TINY, dtype="float32"))
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    rng = np.random.default_rng(71)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 40)]
    again = prompts[1][:36] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)


def _hf_model():
    import transformers

    return hf_random(transformers.ApertusForCausalLM,
                     transformers.ApertusConfig(**HF_APERTUS, attn_implementation="eager"))


def test_logits_match_hf():
    """HF's Apertus (qk-norm weights and layer norms moved) against the
    port's through ``convert_hf_state``, at every position of a 23-token
    prompt: within 1e-4."""
    hf = _hf_model()
    model = port_from_hf("ApertusForCausalLM", ModelConfig.from_hf_config(TINY), hf)
    tokens = np.random.default_rng(5).integers(1, 500, 23).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def test_convert_hf_state_matches_jax():
    """HF's state dict: the port's conversion equals ``params_from_jax`` of
    the JAX package's (its ``HF_LAYER_MAP``; xIELU's beta and eps dropped,
    its scalars f32 [1]) and covers every parameter of the port's model."""
    state = {k: v.detach().float().numpy() for k, v in _hf_model().state_dict().items()}
    cfg = ModelConfig.from_hf_config(TINY, dtype="float32")
    model = get_model_class("ApertusForCausalLM")(cfg, torch.device("cpu"), torch.float32)
    ours = model.convert_hf_state(state)
    jparams = jax_get_model_class("ApertusForCausalLM")(JaxModelConfig.from_hf_config(TINY)).convert_hf_state(
        state, dtype=jnp.float32)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert ours["layers.0.alpha_n"].shape == (1,) and ours["layers.0.alpha_n"].dtype == torch.float32


def test_refusals():
    cfg = ModelConfig.from_hf_config(TINY)
    small = dict(random_weights=True, dtype="float32", device="cpu", page_size=4, max_total_tokens=256)
    for quantization in ("w4a8", "w4a16"):
        with pytest.raises(NotImplementedError, match="not ported"):
            Engine(ServerArgs(**small, quantization=quantization), model_config=cfg)
    eng = Engine(ServerArgs(**small, attention_backend="pallas"), model_config=cfg)
    with pytest.raises(NotImplementedError, match="toppings are not ported"):
        eng.register_topping("ad", state={}, scaling=1.0)
    out = eng.generate(input_ids=[1, 2, 3], sampling_params=SamplingParams(max_new_tokens=3))
    assert len(out.output_ids) == 3
