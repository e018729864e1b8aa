"""The port's GPT-OSS against the JAX package's, on the CPU in f32, and
against HF transformers on the same random weights.

- Logits of extend steps (fresh prompts, a chunk after a cached prefix) and
  teacher-forced decode steps past the local layers' window of 8, both sides
  built from one seeded JAX pytree through ``params_from_jax``, its norms,
  biases and sinks moved at random (the init leaves the sinks at zero):
  ``tiny-gpt-oss``, a YaRN variant (factor 32 over an original context of
  64, so that the ramp dimensions differ from the base), and W4A16 and
  W4A8 (attention projections and every expert's gate|up and down on their
  own codes). Tolerance 1e-4, ``tests/test_torch_model.py``'s.
- Greedy ids of a ``tiny-gpt-oss`` engine against the JAX engine's on the
  same weights, through chunked prefill, a radix hit and decodes that cross
  the window's edge on the local layers: equal, with the port's top-2
  margin above 1e-3 at every step.
- HF's ``GptOssForCausalLM`` (a tiny random config, YaRN with its default
  ``truncate: false``) carried into the port through ``convert_hf_state``:
  every prompt position's logits within 1e-4. The port's ``compute_inv_freq``
  honours ``truncate``: HF's table within 2e-7 either way, the JAX
  package's bit for bit on every config without the key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.models.common import compute_inv_freq as jax_inv_freq
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu_torch.config import ModelConfig
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.common import QuantLinear, compute_inv_freq
from scratchpad_tpu_torch.models.registry import get_model_class
from test_torch_model import TOL, _extend_and_decode
from test_torch_moe import MoePair, engine_pair, greedy_match, synthetic_hf_state
from test_torch_qwen import hf_random, port_from_hf, prompt_logits

YARN = {"rope_type": "yarn", "factor": 32.0, "original_max_position_embeddings": 64,
        "beta_fast": 32.0, "beta_slow": 1.0}
VARIANTS = {
    "tiny-gpt-oss": {"architecture": "GptOssForCausalLM"},
    "yarn": {"architecture": "GptOssForCausalLM", "rope_scaling": YARN},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    pair = MoePair("tiny-gpt-oss", VARIANTS[variant])
    assert pair.model.layer_windows() == [8, None]
    assert pair.model.sm_scale == pytest.approx(pair.jmodel.sm_scale, rel=1e-7)
    _extend_and_decode(pair, TOL)


@pytest.mark.parametrize("quantization", ["w4a8", "w4a16"])
def test_quantized_logits_match_jax(quantization):
    """4-bit q, k, v, o (their biases in f32 beside them) and every
    expert's gate|up and down, each on its slice of the JAX flat stack."""
    pair = MoePair("tiny-gpt-oss", VARIANTS["tiny-gpt-oss"], quantization=quantization)
    layer = pair.model.layers[1]
    assert isinstance(layer.wo, QuantLinear) and layer.wo.bias is not None
    assert len(layer.gate_up) == 4 and layer.gate_up[2].a8 == (quantization == "w4a8")
    assert layer.gate_up_b.dtype == torch.float32
    _extend_and_decode(pair, TOL)


def test_engine_greedy_matches_jax_across_the_window():
    """The window's edge inside the engines: every prompt is longer than the
    local layers' window of 8, and each decode runs 10 tokens past it; the
    chunks of 16 put the edge inside a chunk and across chunks."""
    jeng, eng = engine_pair("tiny-gpt-oss", {})
    model = eng.scheduler.runner.model
    assert type(model).__name__ == "GptOssForCausalLM" and model.layer_windows() == [8, None]
    rng = np.random.default_rng(51)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 40)]
    again = prompts[1][:36] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)


# ------------------------------------------------------------ HF checkpoints

HF_GPT_OSS = dict(
    vocab_size=512, hidden_size=128, intermediate_size=96, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=32, num_local_experts=4,
    num_experts_per_tok=2, sliding_window=8, max_position_embeddings=1024, rms_norm_eps=1e-5,
    rope_theta=10000.0, tie_word_embeddings=False,
    rope_scaling=dict(YARN, truncate=False),
)


@pytest.mark.parametrize("truncate", [False, True])
def test_logits_match_hf(truncate):
    """HF's GPT-OSS on its own random weights (norms, biases and sinks
    moved) against the port's through ``convert_hf_state``, at every position
    of a 40-token prompt (past the window of 8): within 1e-4, with YaRN's
    correction range truncated or not."""
    import transformers

    kw = dict(HF_GPT_OSS, rope_scaling=dict(YARN, truncate=truncate))
    hf = hf_random(transformers.GptOssForCausalLM,
                   transformers.GptOssConfig(**kw, attn_implementation="eager"))
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.self_attn.sinks.normal_(0.0, 2.0)
    cfg = ModelConfig.from_hf_config(dict(kw, architectures=["GptOssForCausalLM"]))
    assert cfg.layer_types is None and cfg.num_experts == 4
    model = port_from_hf("GptOssForCausalLM", cfg, hf)
    tokens = np.random.default_rng(7).integers(1, 500, 40).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def test_yarn_truncate_follows_hf_and_jax():
    """At gpt-oss-20b's geometry: without the key (and with ``truncate:
    true``) the port's table is the JAX package's bit for bit; with
    ``truncate: false`` it is HF's within 2e-7, where the JAX table (which
    always truncates) is 76 % off on the ramp dimensions."""
    from transformers import GptOssConfig
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    base = get_preset("gpt-oss-20b")
    jax_table = jax_inv_freq(jax_get_preset("gpt-oss-20b"))
    np.testing.assert_array_equal(compute_inv_freq(base), jax_table)
    for truncate in (True, False):
        rs = dict(base.rope_scaling, truncate=truncate)
        hf_cfg = GptOssConfig(hidden_size=base.hidden_size, num_attention_heads=64, head_dim=64,
                              rope_theta=base.rope_theta, rope_scaling=rs,
                              max_position_embeddings=base.max_position_embeddings)
        hf_table = _compute_yarn_parameters(hf_cfg, "cpu")[0].numpy()
        ours = compute_inv_freq(dataclasses.replace(base, rope_scaling=rs))
        np.testing.assert_allclose(ours, hf_table, rtol=2e-7, atol=0)
        jax_off = np.max(np.abs(jax_table - hf_table) / hf_table)
        assert jax_off < 2e-7 if truncate else jax_off > 0.7, jax_off
    for preset in ("tiny-gpt-oss", "llama-3.2-1b", "qwen3-8b"):
        for rs in (None, YARN):
            over = {} if rs is None else {"rope_scaling": rs}
            np.testing.assert_array_equal(
                compute_inv_freq(get_preset(preset, **over)),
                jax_inv_freq(jax_get_preset(preset, **over)),
            )


def _gpt_oss_hf_layer(cfg):
    H, D, Hq, Hkv = cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    E, I = cfg.num_experts, cfg.intermediate_size

    def layer(p, rng):
        a = p + "self_attn."
        m = p + "mlp."
        return {
            a + "q_proj.weight": rng.normal(size=(Hq * D, H)), a + "q_proj.bias": rng.normal(size=(Hq * D,)),
            a + "k_proj.weight": rng.normal(size=(Hkv * D, H)), a + "k_proj.bias": rng.normal(size=(Hkv * D,)),
            a + "v_proj.weight": rng.normal(size=(Hkv * D, H)), a + "v_proj.bias": rng.normal(size=(Hkv * D,)),
            a + "o_proj.weight": rng.normal(size=(H, Hq * D)), a + "o_proj.bias": rng.normal(size=(H,)),
            a + "sinks": rng.normal(size=(Hq,)),
            m + "router.weight": rng.normal(size=(E, H)), m + "router.bias": rng.normal(size=(E,)),
            m + "experts.gate_up_proj": rng.normal(size=(E, H, 2 * I)),
            m + "experts.gate_up_proj_bias": rng.normal(size=(E, 2 * I)),
            m + "experts.down_proj": rng.normal(size=(E, I, H)),
            m + "experts.down_proj_bias": rng.normal(size=(E, H)),
            p + "input_layernorm.weight": rng.normal(size=(H,)),
            p + "post_attention_layernorm.weight": rng.normal(size=(H,)),
        }

    return layer


def test_convert_hf_state_matches_jax():
    """A synthetic HF GPT-OSS state dict: the port's state equals
    ``params_from_jax`` of the JAX package's ``convert_hf_state`` (its
    ``_HF_SUB``) and covers every parameter of the port's model."""
    cfg = get_preset("tiny-gpt-oss", dtype="float32")
    model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
    state = synthetic_hf_state(model, _gpt_oss_hf_layer(cfg), seed=9)
    ours = model.convert_hf_state(state)
    jparams = jax_get_model_class(cfg.architecture)(
        jax_get_preset("tiny-gpt-oss", dtype="float32")).convert_hf_state(state, dtype=jnp.float32)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
