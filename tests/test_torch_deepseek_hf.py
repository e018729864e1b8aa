"""The port's DeepSeek-V2 and V3 against HF transformers, and the JAX
package's V3 scale gap, on the CPU in f32 (the tiny config of
``tests/test_torch_deepseek.py``).

- HF's ``DeepseekV2ForCausalLM`` and ``DeepseekV3ForCausalLM`` on their
  random weights (matrices redrawn at N(0, 1/fan_in), norms moved), YaRN
  with ``mscale`` and ``mscale_all_dim`` among them, carried into the port
  through ``convert_hf_state``: every prompt position's logits within 1e-4;
  the converted state equals ``params_from_jax`` of the JAX conversion.
- The JAX V3 scale gap: with V3's published YaRN (factor 40,
  ``mscale_all_dim`` 1) the JAX class scales the scores by 1/1.874 of HF's;
  the port follows HF.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu_torch.config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.registry import get_model_class
from test_torch_deepseek import TINY, V3, V3_YARN, YARN, latent_pools, prompt_logits
from test_torch_model import PS, TOL
import torch_threads  # noqa: F401  (one torch thread a test process)


def hf_deepseek(arch: str, seed: int, **overrides):
    """HF's model (a tiny random config) in f32: every matrix redrawn at
    N(0, 1/fan_in) (HF's init at 0.02 leaves logits near zero, where 1e-4
    sees little), every norm moved by 0.1 N(0, 1), V3's correction bias
    drawn at 0.1 N(0, 1); and the port's config of the same dict."""
    import transformers

    d = dict(TINY, **overrides)
    hf_cls = getattr(transformers, arch)
    hf_cfg = getattr(transformers, arch.replace("ForCausalLM", "Config"))(
        **{k: v for k, v in d.items() if k != "architectures"}, attn_implementation="eager",
    )
    torch.manual_seed(seed)
    hf = hf_cls(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if p.dim() >= 2:
                p.normal_().div_(p.shape[-1] ** 0.5)
            elif "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
        for name, b in hf.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.copy_(0.1 * torch.randn_like(b))
    return hf, ModelConfig.from_hf_config(dict(d, architectures=[arch]), dtype="float32")


@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("DeepseekV2ForCausalLM", {}),
        ("DeepseekV2ForCausalLM", dict(q_lora_rank=24, topk_method="group_limited_greedy",
                                       rope_scaling=YARN)),
        ("DeepseekV3ForCausalLM", dict(V3, rope_scaling=V3_YARN)),
    ],
    ids=["v2", "v2-q-lora-group-limited-yarn", "v3-yarn"],
)
def test_logits_match_hf(arch, overrides):
    """HF's model against the port's through ``convert_hf_state``, every
    position of a 30-token prompt (past YaRN's 32-token original context
    with the decode): within 1e-4. The port's conversion equals
    ``params_from_jax`` of the JAX package's and fills every parameter."""
    hf, cfg = hf_deepseek(arch, seed=5, **overrides)
    model = get_model_class(arch)(cfg, torch.device("cpu"), torch.float32)
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    ours = model.convert_hf_state(state)
    model.load_state_dict(ours)
    tokens = np.random.default_rng(9).integers(1, 500, 40).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)
    jcfg = JaxModelConfig.from_hf_config(dict(TINY, **dict(overrides, architectures=[arch])), dtype="float32")
    jparams = jax_get_model_class(arch)(jcfg).convert_hf_state(
        {k: v.numpy() for k, v in state.items()}, dtype=jnp.float32)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_jax_v3_scale_gap():
    """V3 with its published YaRN pair (factor 40, mscale and mscale_all_dim
    1): HF and the port scale the scores by (dn + dr)^-0.5 * 1.874, the
    JAX class by (dn + dr)^-0.5 alone (``deepseek.py:92``), so its logits
    leave HF's; given HF's scale, the JAX class meets the port within 1e-4.
    V2 applies no such factor on either side."""
    hf, cfg = hf_deepseek("DeepseekV3ForCausalLM", seed=7, **V3, rope_scaling=V3_YARN)
    jcfg = JaxModelConfig.from_hf_config(dict(TINY, **V3, rope_scaling=V3_YARN), dtype="float32")
    model = get_model_class("DeepseekV3ForCausalLM")(cfg, torch.device("cpu"), torch.float32)
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    model.load_state_dict(model.convert_hf_state(state))
    jmodel = jax_get_model_class("DeepseekV3ForCausalLM")(jcfg)
    jmodel.page_size = PS
    base = (TINY["qk_nope_head_dim"] + TINY["qk_rope_head_dim"]) ** -0.5
    assert jmodel.sm_scale == pytest.approx(base, rel=1e-12)
    assert model.sm_scale / jmodel.sm_scale == pytest.approx((0.1 * np.log(40.0) + 1) ** 2, rel=1e-12)
    assert hf.model.layers[0].self_attn.scaling == pytest.approx(model.sm_scale, rel=1e-12)
    v2 = get_model_class("DeepseekV2ForCausalLM")(
        dataclasses.replace(cfg, architecture="DeepseekV2ForCausalLM"), torch.device("cpu"), torch.float32)
    assert v2.sm_scale == pytest.approx(base, rel=1e-12)

    params = jax.tree.map(jnp.asarray, jmodel.convert_hf_state(
        {k: v.numpy() for k, v in state.items()}, dtype=jnp.float32))
    tokens = np.random.default_rng(4).integers(1, 500, 24)
    n = len(tokens)

    def jax_logits():
        jkv, _ = latent_pools(cfg.num_hidden_layers, 8)
        pages = np.arange(1, 7)
        pos = np.arange(n)
        jmeta = JaxMeta(mode=JaxMode.EXTEND, tokens=jnp.asarray(tokens, jnp.int32),
                        positions=jnp.asarray(pos, jnp.int32),
                        out_cache_loc=jnp.asarray(pages[pos // PS] * PS + pos % PS, jnp.int32),
                        req_indices=jnp.zeros(n, jnp.int32), page_table=jnp.asarray(pages[None], jnp.int32),
                        seq_lens=jnp.asarray([n], jnp.int32), extend_lens=jnp.asarray([n], jnp.int32),
                        last_token_idx=jnp.asarray([n - 1], jnp.int32))
        return np.asarray(jmodel(params, jkv, jmeta)[1])[0]

    ours = prompt_logits(model, tokens.tolist())[-1].numpy()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens.tolist()])).logits[0, -1].float().numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    gap = float(np.abs(jax_logits() - ref).max())
    assert gap > 100 * TOL["atol"], gap
    jmodel.sm_scale = model.sm_scale
    np.testing.assert_allclose(jax_logits(), ref, **TOL)


