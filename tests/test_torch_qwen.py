"""The port's Qwen2, Qwen3 and Phi-3 against the JAX package's, on the CPU in
f32, and against HF transformers on the same random weights.

- Logits of extend steps (fresh prompts, a chunk after a cached prefix) and
  teacher-forced decode steps, both sides built from one seeded JAX pytree
  through ``params_from_jax`` (its biases and norms drawn at random, so that
  a missing or misplaced one shows): Qwen2 (q, k, v biases), Qwen3 (qk-norm),
  Qwen3 with W4A8 (its norms stay in the model dtype beside the 4-bit
  projections), Phi-3. Tolerance 1e-4, ``tests/test_torch_model.py``'s.
- Greedy ids of each engine against the JAX engine's on the same weights,
  through chunked prefill and a radix hit: equal, with the port's top-2
  margin above 1e-3 at every step.
- HF's ``Qwen2ForCausalLM`` and ``Qwen3ForCausalLM`` (tiny random configs)
  carried into the port through ``convert_hf_state``: the logits of every
  prompt position within 1e-4; Phi-3's fused checkpoint split as the JAX
  package splits it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.models.common import make_w4a8_quant_matmul
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu.ops.quant import quantize_model_params as jax_quantize_model_params
from scratchpad_tpu.ops.quant import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.common import QuantLinear
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import _teacher_forced_margins
from test_torch_model import PS, TOL, Pair, _extend_and_decode
import torch_threads  # noqa: F401  (one torch thread a test process)

MARGIN = 1e-3
QWEN_ARCHS = ["Qwen2ForCausalLM", "Qwen3ForCausalLM", "Phi3ForCausalLM"]
ENGINE_ARGS = dict(
    random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048,
    chunked_prefill_size=16,
)


def perturbed(params: dict, seed: int) -> dict:
    """The pytree with every norm and bias moved by 0.1 N(0, 1) (numpy, f32):
    the random init leaves norms at one (zero for Gemma's 1 + w) and
    biases at zero, which would hide a norm or a bias that the port drops or
    misplaces."""
    rng = np.random.default_rng(seed)

    def move(name, a):
        a = np.asarray(a, np.float32)
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a

    out = {k: move(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: move(k, v) for k, v in params["layers"].items()}
    return out


class ArchPair(Pair):
    """``Pair`` for any ported architecture: the JAX model of ``arch`` and the
    port's, both from one seeded JAX pytree, ``perturbed``; a preset and its
    overrides give the shapes."""

    def __init__(self, arch, preset="tiny-debug", overrides=None, quantization=None, num_pages=64):
        overrides = dict(overrides or {}, architecture=arch)
        self.jcfg = jax_get_preset(preset, dtype="float32", **overrides)
        self.cfg = get_preset(preset, dtype="float32", **overrides)
        self.jmodel = jax_get_model_class(arch)(self.jcfg)
        self.jmodel.page_size = PS
        params = perturbed(jax.tree.map(np.asarray, self.jmodel.init_params(
            jax.random.PRNGKey(0), jnp.float32)), seed=1)
        self.params = jax.tree.map(jnp.asarray, params)
        if quantization is not None:
            self.params = jax_quantize_model_params(self.params, fuse_gate_up=True)
            head = self.params.pop("lm_head")
            self.params["lm_head_q"] = jax_quantize_stacked(jnp.swapaxes(head, 0, 1)[None])
            if quantization == "w4a8":
                self.jmodel.quant_matmul = make_w4a8_quant_matmul()
        self.model = get_model_class(arch)(
            self.cfg, torch.device("cpu"), torch.float32,
            quantization=quantization, quantize_lm_head=quantization is not None,
        )
        self.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, self.params), self.cfg))
        self.model.decode_attention, self.model.extend_attention = attention_functions("auto")
        L, Hkv, D = self.cfg.num_hidden_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        self.jkv = jax_create_kv_cache(JaxKVConfig(
            num_layers=L, num_pages=num_pages, page_size=PS, num_kv_heads=Hkv, head_dim=D,
            dtype=jnp.float32,
        ))
        self.kv = create_kv_cache(KVCacheConfig(L, num_pages, PS, Hkv, D, torch.float32),
                                  torch.device("cpu"))


@pytest.mark.parametrize("arch", QWEN_ARCHS)
def test_logits_match_jax(arch):
    pair = ArchPair(arch)
    assert pair.cfg.attention_bias == (arch == "Qwen2ForCausalLM")
    assert pair.cfg.use_qk_norm == (arch == "Qwen3ForCausalLM")
    _extend_and_decode(pair, TOL)


def test_qwen3_w4a8_logits_match_jax():
    """Qwen3 with W4A8 projections and head; the qk-norms stay f32 (the model
    dtype) parameters beside the ``QuantLinear``s."""
    pair = ArchPair("Qwen3ForCausalLM", quantization="w4a8")
    layer = pair.model.layers[0]
    assert isinstance(layer.wq, QuantLinear) and layer.wq.a8
    assert isinstance(layer.q_norm, torch.nn.Parameter) and layer.q_norm.dtype == torch.float32
    _extend_and_decode(pair, TOL)


def _jax_cfg(arch, preset="tiny-debug", **kw):
    return jax_get_preset(preset, dtype="float32", architecture=arch, **kw)


def engine_pair(arch, preset="tiny-debug", **overrides):
    """A JAX engine and a port engine (CPU) on the same perturbed weights."""
    jeng = JaxEngine(JaxServerArgs(**ENGINE_ARGS), model_config=_jax_cfg(arch, preset, **overrides))
    jrunner = jeng.scheduler.runner
    assert not getattr(jrunner.model, "weights_transposed", False)
    params = perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    cfg = get_preset(preset, dtype="float32", architecture=arch, **overrides)
    eng = Engine(ServerArgs(device="cpu", **ENGINE_ARGS), model_config=cfg)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def greedy_match(jeng, eng, prompts, again, n_new=10):
    """Greedy ids of both engines on ``prompts`` (one batch), then ``again``
    (a radix hit on the first prompt's prefix): equal, each step's port
    margin above ``MARGIN``."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=n_new)
    jsp = JaxSamplingParams(temperature=0.0, max_new_tokens=n_new)
    outs = eng.generate(input_ids=prompts, sampling_params=[sp] * len(prompts))
    jouts = jeng.generate(input_ids=prompts, sampling_params=[jsp] * len(prompts))
    out2 = eng.generate(input_ids=again, sampling_params=sp)
    jout2 = jeng.generate(input_ids=again, sampling_params=jsp)
    assert out2.cached_tokens == jout2.cached_tokens > 0
    for p, o, j in zip(prompts + [again], outs + [out2], jouts + [jout2]):
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids
        assert min(margins) > MARGIN, min(margins)
        assert o.output_ids == j.output_ids and len(o.output_ids) == n_new
    eng.scheduler.check_memory_leak()


@pytest.mark.parametrize("arch", QWEN_ARCHS)
def test_engine_greedy_matches_jax(arch):
    jeng, eng = engine_pair(arch)
    assert type(eng.scheduler.runner.model).__name__ == arch
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 7, 40)]
    again = prompts[2][:36] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)


# ------------------------------------------------------------ HF checkpoints


def prompt_logits(model, tokens) -> torch.Tensor:
    """f32 logits [n, V] of every position of one prompt through the port
    model's extend on a fresh pool (page 4)."""
    cfg = model.cfg
    n = len(tokens)
    pages = np.arange(1, -(-n // PS) + 1)
    kv = create_kv_cache(
        KVCacheConfig(cfg.num_hidden_layers, len(pages) + 1, PS, cfg.num_kv_heads, cfg.head_dim,
                      torch.float32),
        torch.device("cpu"),
    )
    pos = np.arange(n)
    meta = ForwardMeta(
        mode=ForwardMode.EXTEND, tokens=torch.tensor(tokens), positions=torch.from_numpy(pos),
        out_cache_loc=torch.from_numpy(pages[pos // PS] * PS + pos % PS),
        req_indices=torch.zeros(n, dtype=torch.long),
        page_table=torch.from_numpy(pages[None].astype(np.int32)),
        seq_lens=torch.tensor([n], dtype=torch.int32), extend_lens=torch.tensor([n], dtype=torch.int32),
        last_token_idx=torch.tensor([n - 1]), cu_q_lens=torch.tensor([0, n], dtype=torch.int32),
        capture_all_hidden=True,
    )
    with torch.inference_mode():
        return model.head_logits(model(meta, kv))


def hf_random(model_cls, hf_cfg, seed=0):
    """An HF model in f32 with its random init, every norm moved by 0.1 N(0,
    1) and every bias drawn (the init leaves them at one and zero)."""
    torch.manual_seed(seed)
    hf = model_cls(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    return hf


def port_from_hf(arch, cfg, hf):
    model = get_model_class(arch)(cfg, torch.device("cpu"), torch.float32)
    model.load_state_dict(model.convert_hf_state(dict(hf.state_dict())))
    model.decode_attention, model.extend_attention = attention_functions("auto")
    return model


HF_TINY = dict(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=1024,
    rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
)


@pytest.mark.parametrize("arch", ["Qwen2ForCausalLM", "Qwen3ForCausalLM"])
def test_logits_match_hf(arch):
    """HF's model on its own random weights (q, k, v biases for Qwen2,
    qk-norm for Qwen3) against the port's through ``convert_hf_state``, at
    every position of a 23-token prompt: within 1e-4."""
    import transformers

    hf_cfg = getattr(transformers, arch.replace("ForCausalLM", "Config"))(
        **HF_TINY, attn_implementation="eager")
    hf = hf_random(getattr(transformers, arch), hf_cfg)
    model = port_from_hf(arch, ModelConfig.from_hf_config(dict(HF_TINY, architectures=[arch])), hf)
    tokens = np.random.default_rng(5).integers(1, 500, 23).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def test_phi3_splits_fused_checkpoints_as_jax():
    """A synthetic Phi-3 state dict with fused ``qkv_proj`` and
    ``gate_up_proj``: the port's state equals ``params_from_jax`` of the JAX
    package's conversion, and no fused name is left unmapped."""
    arch = "Phi3ForCausalLM"
    cfg = get_preset("tiny-debug", dtype="float32", architecture=arch)
    jcfg = _jax_cfg(arch)
    H, D, Hq, Hkv, I = (cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads,
                        cfg.intermediate_size)
    rng = np.random.default_rng(3)
    state = {
        "model.embed_tokens.weight": rng.normal(size=(cfg.vocab_size, H)),
        "model.norm.weight": rng.normal(size=(H,)),
        "lm_head.weight": rng.normal(size=(cfg.vocab_size, H)),
    }
    for l in range(cfg.num_hidden_layers):
        p = f"model.layers.{l}."
        state[p + "self_attn.qkv_proj.weight"] = rng.normal(size=((Hq + 2 * Hkv) * D, H))
        state[p + "self_attn.o_proj.weight"] = rng.normal(size=(H, Hq * D))
        state[p + "mlp.gate_up_proj.weight"] = rng.normal(size=(2 * I, H))
        state[p + "mlp.down_proj.weight"] = rng.normal(size=(H, I))
        state[p + "input_layernorm.weight"] = rng.normal(size=(H,))
        state[p + "post_attention_layernorm.weight"] = rng.normal(size=(H,))
    state = {k: v.astype(np.float32) for k, v in state.items()}
    model = get_model_class(arch)(cfg, torch.device("cpu"), torch.float32)
    ours = model.convert_hf_state(state)
    jparams = jax_get_model_class(arch)(jcfg).convert_hf_state(state, dtype=jnp.float32)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_registry_maps_the_ported_families():
    from scratchpad_tpu_torch.models.apertus import ApertusForCausalLM
    from scratchpad_tpu_torch.models.deepseek import DeepseekV2ForCausalLM, DeepseekV3ForCausalLM
    from scratchpad_tpu_torch.models.gemma import (
        Gemma2ForCausalLM,
        Gemma3ForCausalLM,
        Gemma3ForConditionalGeneration,
    )
    from scratchpad_tpu_torch.models.gpt_oss import GptOssForCausalLM
    from scratchpad_tpu_torch.models.llava import LlavaForConditionalGeneration
    from scratchpad_tpu_torch.models.qwen2_vl import Qwen2VLForConditionalGeneration
    from scratchpad_tpu_torch.models.llama4 import Llama4ForCausalLM
    from scratchpad_tpu_torch.models.mixtral import MixtralForCausalLM, Qwen3MoeForCausalLM
    from scratchpad_tpu_torch.models.qwen import Phi3ForCausalLM, Qwen2ForCausalLM, Qwen3ForCausalLM

    for name, cls in (("Qwen2ForCausalLM", Qwen2ForCausalLM), ("Qwen3ForCausalLM", Qwen3ForCausalLM),
                      ("Phi3ForCausalLM", Phi3ForCausalLM), ("Gemma2ForCausalLM", Gemma2ForCausalLM),
                      ("Gemma3ForCausalLM", Gemma3ForCausalLM),
                      ("MixtralForCausalLM", MixtralForCausalLM),
                      ("Qwen3MoeForCausalLM", Qwen3MoeForCausalLM),
                      ("GptOssForCausalLM", GptOssForCausalLM),
                      ("Llama4ForCausalLM", Llama4ForCausalLM), ("Llama4TextModel", Llama4ForCausalLM),
                      ("ApertusForCausalLM", ApertusForCausalLM),
                      ("DeepseekV2ForCausalLM", DeepseekV2ForCausalLM),
                      ("DeepseekV3ForCausalLM", DeepseekV3ForCausalLM),
                      ("LlavaForConditionalGeneration", LlavaForConditionalGeneration),
                      ("Qwen2VLForConditionalGeneration", Qwen2VLForConditionalGeneration),
                      ("Gemma3ForConditionalGeneration", Gemma3ForConditionalGeneration)):
        assert get_model_class(name) is cls
    for name in ("Llama4ForConditionalGeneration", "MllamaForConditionalGeneration"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_model_class(name)
