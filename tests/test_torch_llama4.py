"""The port's Llama-4 text decoder against the JAX package's, on the CPU in
f32, and against HF transformers on the same random weights.

Two layouts of a tiny config (10 query heads over 2 kv heads, G 5 as Scout;
chunks of 8 and a NoPE temperature floor of 8, so that prompts past 16
tokens cross both): "maverick", dense and MoE layers in turn
(``interleave_moe_layer_step`` 2, Maverick's structure), and "scout", every
layer MoE. The rope layers attend in chunks, the fourth layer is NoPE.

- Logits of extend steps (fresh prompts, a chunk after a cached prefix) and
  teacher-forced decode steps, both sides built from one seeded JAX pytree
  (a list of per-layer dicts) through ``params_from_jax``, its norms moved
  at random. Tolerance 1e-4, ``tests/test_torch_model.py``'s.
- Greedy ids of the engines: ``tests/test_torch_llama4_engine.py`` (its own
  file: the JAX engine's compiles make one file of both too slow for the
  six-worker run).
- HF's ``Llama4ForCausalLM`` (a tiny random config) carried into the port
  through ``convert_hf_state``: every prompt position's logits within 1e-4;
  the port's conversion of a synthetic HF state equals ``params_from_jax``
  of the JAX package's (its ``_HF_SUB`` names).
- ``no_rope_layers`` follows HF where the list is left out or empty (every
  fourth layer NoPE); the JAX copy then makes every layer a rope layer (a
  gap recorded in ``ROADMAP.md``, not copied).
- Refusals: ``attention_backend="pallas"``, quantization, toppings; an
  explicit int8 KV pool serves.
- Scout's rope table (``chip_smoke.LLAMA4_SCOUT``'s Llama-3 scaling, whose
  smoothing band is empty) against HF and JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_model import PS, TOL, Pair, _extend_and_decode
from test_torch_moe import synthetic_hf_state
from test_torch_qwen import hf_random, port_from_hf, prompt_logits

TINY = dict(
    architectures=["Llama4ForCausalLM"], vocab_size=512, hidden_size=128, intermediate_size=96,
    intermediate_size_mlp=160, num_hidden_layers=4, num_attention_heads=10, num_key_value_heads=2,
    head_dim=32, num_local_experts=4, num_experts_per_tok=2, use_qk_norm=True,
    attn_temperature_tuning=True, floor_scale=8, attn_scale=0.1, attention_chunk_size=8,
    max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0,
    rope_scaling={"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    tie_word_embeddings=False, no_rope_layers=[1, 1, 1, 0],
)
LAYOUTS = {
    "maverick": dict(interleave_moe_layer_step=2),
    "scout": dict(interleave_moe_layer_step=1),
}


def configs(layout: str):
    """The JAX and the port config of one layout, from one HF-style dict."""
    d = dict(TINY, **LAYOUTS[layout])
    return JaxModelConfig.from_hf_config(d, dtype="float32"), ModelConfig.from_hf_config(d, dtype="float32")


def perturbed(params: dict, seed: int) -> dict:
    """The pytree (numpy, f32; its layers a list of dicts) with every norm
    moved by 0.1 N(0, 1): the init leaves them at one."""
    rng = np.random.default_rng(seed)

    def move(name, a):
        a = np.asarray(a, np.float32)
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32) if name.endswith("norm") else a

    out = {k: move(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: move(k, v) for k, v in lp.items()} for lp in params["layers"]]
    return out


class Llama4Pair(Pair):
    """The JAX and the port Llama-4 on one perturbed JAX pytree, each with
    its pool (``Pair.step`` drives both)."""

    def __init__(self, layout, num_pages=64):
        self.jcfg, self.cfg = configs(layout)
        self.jmodel = jax_get_model_class("Llama4ForCausalLM")(self.jcfg)
        self.jmodel.page_size = PS
        params = perturbed(jax.tree.map(np.asarray, self.jmodel.init_params(
            jax.random.PRNGKey(0), jnp.float32)), seed=1)
        self.params = jax.tree.map(jnp.asarray, params)
        self.model = get_model_class("Llama4ForCausalLM")(self.cfg, torch.device("cpu"), torch.float32)
        self.model.load_state_dict(params_from_jax(params, self.cfg))
        self.model.decode_attention, self.model.extend_attention = attention_functions("auto")
        L, Hkv, D = self.cfg.num_hidden_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        self.jkv = jax_create_kv_cache(JaxKVConfig(
            num_layers=L, num_pages=num_pages, page_size=PS, num_kv_heads=Hkv, head_dim=D,
            dtype=jnp.float32,
        ))
        self.kv = create_kv_cache(KVCacheConfig(L, num_pages, PS, Hkv, D, torch.float32),
                                  torch.device("cpu"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_logits_match_jax(layout):
    pair = Llama4Pair(layout)
    model = pair.model
    assert model.use_rope == [True, True, True, False] == pair.jmodel.use_rope
    assert model.layer_chunks == [8, 8, 8, None]
    assert {l for l, layer in enumerate(model.layers) if layer.moe} == pair.jmodel.moe_layers
    assert model.layers[0].moe == (layout == "scout")
    _extend_and_decode(pair, TOL)


HF_LLAMA4 = {k: v for k, v in TINY.items() if k not in ("architectures", "no_rope_layers")}


def test_logits_match_hf():
    """HF's Llama-4 (dense and MoE layers in turn, its own no_rope_layers)
    on its random weights against the port's through ``convert_hf_state``,
    at every position of a 30-token prompt: within 1e-4."""
    import transformers

    hf_cfg = transformers.Llama4TextConfig(**HF_LLAMA4, interleave_moe_layer_step=2,
                                           attn_implementation="eager")
    hf = hf_random(transformers.Llama4ForCausalLM, hf_cfg)
    cfg = ModelConfig.from_hf_config(dict(HF_LLAMA4, interleave_moe_layer_step=2,
                                          architectures=["Llama4ForCausalLM"]))
    assert cfg.no_rope_layers == list(hf_cfg.no_rope_layers) == [1, 1, 1, 0]
    model = port_from_hf("Llama4ForCausalLM", cfg, hf)
    tokens = np.random.default_rng(9).integers(1, 500, 30).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def _llama4_hf_layer(cfg, moe_layers):
    H, D, Hq, Hkv = cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    E, I, Im = cfg.num_experts, cfg.intermediate_size, cfg.intermediate_size_mlp

    def layer(p, rng):
        a, f = p + "self_attn.", p + "feed_forward."
        out = {
            a + "q_proj.weight": rng.normal(size=(Hq * D, H)),
            a + "k_proj.weight": rng.normal(size=(Hkv * D, H)),
            a + "v_proj.weight": rng.normal(size=(Hkv * D, H)),
            a + "o_proj.weight": rng.normal(size=(H, Hq * D)),
            p + "input_layernorm.weight": rng.normal(size=(H,)),
            p + "post_attention_layernorm.weight": rng.normal(size=(H,)),
        }
        if int(p.split(".")[2]) in moe_layers:
            out.update({
                f + "router.weight": rng.normal(size=(E, H)),
                f + "experts.gate_up_proj": rng.normal(size=(E, H, 2 * I)),
                f + "experts.down_proj": rng.normal(size=(E, I, H)),
                f + "shared_expert.gate_proj.weight": rng.normal(size=(I, H)),
                f + "shared_expert.up_proj.weight": rng.normal(size=(I, H)),
                f + "shared_expert.down_proj.weight": rng.normal(size=(H, I)),
            })
        else:
            out.update({
                f + "gate_proj.weight": rng.normal(size=(Im, H)),
                f + "up_proj.weight": rng.normal(size=(Im, H)),
                f + "down_proj.weight": rng.normal(size=(H, Im)),
            })
        return out

    return layer


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_convert_hf_state_matches_jax(layout):
    """A synthetic HF Llama-4 state: the port's state equals ``params_from_jax``
    of the JAX package's ``convert_hf_state`` (a list of per-layer dicts)
    and covers every parameter of the port's model."""
    jcfg, cfg = configs(layout)
    model = get_model_class("Llama4ForCausalLM")(cfg, torch.device("cpu"), torch.float32)
    jmodel = jax_get_model_class("Llama4ForCausalLM")(jcfg)
    state = synthetic_hf_state(model, _llama4_hf_layer(cfg, jmodel.moe_layers), seed=3)
    ours = model.convert_hf_state(state)
    jparams = jmodel.convert_hf_state(state, dtype=jnp.float32)
    assert isinstance(jparams["layers"], list)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("no_rope_layers", [None, []])
def test_no_rope_layers_follow_hf(no_rope_layers):
    """Left out or empty, the list is HF's: every fourth layer NoPE
    (``Llama4TextConfig``). The JAX copy reads such a config as all rope
    layers; an explicit list is kept on both sides."""
    from transformers import Llama4TextConfig

    d = {k: v for k, v in TINY.items() if k != "no_rope_layers"}
    d["num_hidden_layers"] = 8
    if no_rope_layers is not None:
        d["no_rope_layers"] = no_rope_layers
    hf = Llama4TextConfig(**{k: v for k, v in d.items() if k != "architectures"})
    cfg = ModelConfig.from_hf_config(d)
    assert cfg.no_rope_layers == list(hf.no_rope_layers) == [1, 1, 1, 0, 1, 1, 1, 0]
    model = get_model_class("Llama4TextModel")(cfg, torch.device("cpu"), torch.float32)
    assert model.layer_chunks == [8, 8, 8, None] * 2
    assert jax_get_model_class("Llama4ForCausalLM")(JaxModelConfig.from_hf_config(d)).use_rope == [True] * 8
    explicit = dict(d, no_rope_layers=[0, 1] * 4)
    assert ModelConfig.from_hf_config(explicit).no_rope_layers == [0, 1] * 4
    assert jax_get_model_class("Llama4ForCausalLM")(
        JaxModelConfig.from_hf_config(explicit)).use_rope == [False, True] * 4


def test_refusals_and_int8_kv():
    """``attention_backend="pallas"``, quantization and toppings are refused;
    an explicit int8 KV pool serves (the attention kernels' 8-bit branches,
    here their plain versions)."""
    _, cfg = configs("maverick")
    small = dict(random_weights=True, dtype="float32", device="cpu", page_size=4, max_total_tokens=256)
    with pytest.raises(NotImplementedError, match="attention_backend='pallas'"):
        Engine(ServerArgs(**small, attention_backend="pallas"), model_config=cfg)
    for quantization in ("w4a8", "w4a16"):
        with pytest.raises(NotImplementedError, match="not ported"):
            Engine(ServerArgs(**small, quantization=quantization), model_config=cfg)
    eng = Engine(ServerArgs(**small, kv_cache_dtype="int8"), model_config=cfg)
    with pytest.raises(NotImplementedError, match="toppings are not ported"):
        eng.register_topping("ad", state={}, scaling=1.0)
    assert eng.scheduler.runner.kv_cache.quantized
    out = eng.generate(input_ids=list(range(1, 20)), sampling_params=SamplingParams(max_new_tokens=4))
    assert len(out.output_ids) == 4


def test_scout_rope_table_matches_hf_and_jax():
    """Scout's Llama-3 scaling (factor 16 over 8,192, low and high factors
    both 1: the smoothing band is empty): the port's table is the JAX
    package's bit for bit, finite, and HF's within 2e-7."""
    import warnings

    from transformers import Llama4TextConfig
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    from chip_smoke import LLAMA4_SCOUT
    from scratchpad_tpu.models.common import compute_inv_freq as jax_inv_freq
    from scratchpad_tpu_torch.models.common import compute_inv_freq

    with warnings.catch_warnings():  # the empty band divides by zero in both copies
        warnings.simplefilter("ignore", RuntimeWarning)
        ours = compute_inv_freq(ModelConfig.from_hf_config(LLAMA4_SCOUT))
        theirs = jax_inv_freq(JaxModelConfig.from_hf_config(LLAMA4_SCOUT))
    assert np.isfinite(ours).all()
    np.testing.assert_array_equal(ours, theirs)
    hf = ROPE_INIT_FUNCTIONS["llama3"](Llama4TextConfig(rope_scaling=LLAMA4_SCOUT["rope_scaling"]), "cpu")[0]
    np.testing.assert_allclose(ours, hf.numpy(), rtol=2e-7, atol=0)
