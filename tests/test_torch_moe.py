"""The port's Mixtral against the JAX package's, on the CPU in f32, and
against HF transformers on the same random weights; the rules that the MoE
families bring to the runner, the loader and the engine. Qwen3-MoE takes the
same tests in ``tests/test_torch_qwen3_moe.py`` (its own file: the JAX
side's compiles make one file of both too slow for the six-worker run).

- Logits of extend steps (fresh prompts, a chunk after a cached prefix) and
  teacher-forced decode steps, both sides built from one seeded JAX pytree
  through ``params_from_jax``, its norms moved at random (the init leaves
  them at one): bf16-layout weights, W4A16 and W4A8 (every expert its own
  codes, so that a wrong ``layer * E + e`` index shows). Tolerance 1e-4,
  ``tests/test_torch_model.py``'s.
- Greedy ids of each engine against the JAX engine's on the same weights,
  through a batched prefill and a radix hit: equal, with the port's top-2
  margin above 1e-3 at every step.
- HF's ``MixtralForCausalLM`` and ``Qwen3MoeForCausalLM`` (tiny random
  configs) carried into the port through ``convert_hf_state``: every
  prompt position's logits within 1e-4; the port's conversion of a synthetic
  HF state equals ``params_from_jax`` of the JAX package's.
- ``params_from_jax`` keeps each expert's codes at its flat index and
  refuses a transposed expert ``down``; ``resolve_kv_cache_dtype`` gives a
  W4 Qwen3-30B-A3B int8 KV and a W4 GPT-OSS-20B bf16 KV under ``auto``, as
  the JAX rule does; toppings, fp8 experts, expert parallelism and
  GPT-OSS under ``attention_backend="pallas"`` are refused.
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
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.model_runner import resolve_kv_cache_dtype
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax, quantized_layer_state
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.common import QuantLinear
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.ops.quant.w4_matmul import pack_w4
from scratchpad_tpu_torch.ops.quant.w4a16 import QuantizedLinear
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import _teacher_forced_margins
from test_torch_model import PS, TOL, Pair, _extend_and_decode
from test_torch_qwen import HF_TINY, hf_random, port_from_hf, prompt_logits

MARGIN = 1e-3
ENGINE_ARGS = dict(
    random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048,
    chunked_prefill_size=16,
)
# tiny-debug's shapes with experts: E 4, top-2, an expert width that is
# neither the hidden size nor the dense one (so that a transposed stack
# fails its shape check)
MIXTRAL = dict(architecture="MixtralForCausalLM", num_experts=4, num_experts_per_tok=2)
QWEN3_MOE = dict(
    architecture="Qwen3MoeForCausalLM", num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=96, norm_topk_prob=True,
)
VARIANTS = {
    "mixtral": ("tiny-debug", MIXTRAL),
    "qwen3-moe": ("tiny-debug", QWEN3_MOE),
    "qwen3-moe-unnormed": ("tiny-debug", dict(QWEN3_MOE, norm_topk_prob=False)),
}
# the MoE families' biases and sinks, moved at random with the norms
_MOVED = {"bq": 0.1, "bk": 0.1, "bv": 0.1, "bo": 0.1, "router_b": 0.1, "gate_up_b": 0.1,
          "down_b": 0.1, "sinks": 2.0}


def moe_perturbed(params: dict, seed: int) -> dict:
    """The pytree (numpy, f32) with every norm moved by 0.1 N(0, 1), every
    bias by 0.1 N(0, 1) and the sinks by 2 N(0, 1): the random init leaves
    norms at one and biases and sinks at zero, which would hide one that
    the port drops or misplaces."""
    rng = np.random.default_rng(seed)

    def move(name, a):
        a = np.asarray(a, np.float32)
        if name.endswith("norm"):
            return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if name in _MOVED:
            return a + _MOVED[name] * rng.normal(size=a.shape).astype(np.float32)
        return a

    out = {k: move(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: move(k, v) for k, v in params["layers"].items()}
    return out


class MoePair(Pair):
    """The JAX and the port MoE model on one perturbed JAX pytree, each with
    its pool; ``quantization`` quantizes the JAX parameters as its runner
    does for these classes (q, k, v, o and the expert stacks, unfused; the
    head stays) and gives its model the runner's matmul."""

    def __init__(self, preset, overrides, quantization=None, num_pages=64):
        arch = overrides["architecture"]
        self.jcfg = jax_get_preset(preset, dtype="float32", **overrides)
        self.cfg = get_preset(preset, dtype="float32", **overrides)
        self.jmodel = jax_get_model_class(arch)(self.jcfg)
        self.jmodel.page_size = PS
        params = moe_perturbed(jax.tree.map(np.asarray, self.jmodel.init_params(
            jax.random.PRNGKey(0), jnp.float32)), seed=1)
        self.params = jax.tree.map(jnp.asarray, params)
        if quantization is not None:
            self.params = jax_quantize_model_params(self.params)
            if quantization == "w4a8":
                self.jmodel.quant_matmul = make_w4a8_quant_matmul()
        self.model = get_model_class(arch)(
            self.cfg, torch.device("cpu"), torch.float32, quantization=quantization
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


@pytest.mark.parametrize("variant", ["mixtral"])
def test_logits_match_jax(variant):
    pair = MoePair(*VARIANTS[variant])
    assert pair.cfg.use_qk_norm == (variant != "mixtral")
    _extend_and_decode(pair, TOL)


@pytest.mark.parametrize("variant, quantization", [("mixtral", "w4a8")])
def test_quantized_logits_match_jax(variant, quantization):
    """4-bit attention projections and experts (each expert its own
    ``QuantLinear`` on its slice of the JAX flat stack), the head in f32;
    each route on one family (GPT-OSS takes both)."""
    pair = MoePair(*VARIANTS[variant], quantization=quantization)
    layer = pair.model.layers[1]
    assert isinstance(layer.wq, QuantLinear) and layer.wq.a8 == (quantization == "w4a8")
    assert len(layer.w2) == 4 and isinstance(layer.w2[3], QuantLinear)
    assert pair.model.lm_head is not None and "lm_head_q" not in pair.params
    _extend_and_decode(pair, TOL)


def engine_pair(preset, overrides, chunk=16):
    """A JAX engine and a port engine (CPU) on the same perturbed weights,
    prefilling ``chunk`` tokens at a time."""
    args = dict(ENGINE_ARGS, chunked_prefill_size=chunk)
    # no start-up compile of the JAX decode bucket ladder: the test's own
    # batches compile what they use
    jeng = JaxEngine(JaxServerArgs(**args, warmup_capture=False),
                     model_config=jax_get_preset(preset, dtype="float32", **overrides))
    jrunner = jeng.scheduler.runner
    params = moe_perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    eng = Engine(ServerArgs(device="cpu", **args),
                 model_config=get_preset(preset, dtype="float32", **overrides))
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


@pytest.mark.parametrize("variant", ["mixtral"])
def test_engine_greedy_matches_jax(variant):
    """Three prompts in one extend batch (the JAX engine compiles one shape
    a batch: chunks of 128 keep this test's compiles few), then a radix
    hit; ``tests/test_torch_gpt_oss.py`` runs the chunked prefill."""
    jeng, eng = engine_pair(*VARIANTS[variant], chunk=128)
    assert type(eng.scheduler.runner.model).__name__ == VARIANTS[variant][1]["architecture"]
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 7, 40)]
    again = prompts[2][:36] + rng.integers(1, 500, 3).tolist()
    greedy_match(jeng, eng, prompts, again)


# ------------------------------------------------------------ HF checkpoints

HF_MOE = {
    "MixtralForCausalLM": dict(num_local_experts=4, num_experts_per_tok=2),
    "Qwen3MoeForCausalLM": dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
                                norm_topk_prob=True, decoder_sparse_step=1),
}


@pytest.mark.parametrize("arch", ["MixtralForCausalLM"])
def test_logits_match_hf(arch):
    """HF's model on its own random weights (norms moved) against the port's
    through ``convert_hf_state``, at every position of a 23-token prompt:
    within 1e-4."""
    import transformers

    kw = dict(HF_TINY, **HF_MOE[arch])
    hf_cfg = getattr(transformers, arch.replace("ForCausalLM", "Config"))(
        **kw, attn_implementation="eager")
    hf = hf_random(getattr(transformers, arch), hf_cfg)
    cfg = ModelConfig.from_hf_config(dict(kw, architectures=[arch]))
    assert cfg.num_experts == 4
    model = port_from_hf(arch, cfg, hf)
    tokens = np.random.default_rng(6).integers(1, 500, 23).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def synthetic_hf_state(model, prefix_fn, seed):
    """Random f32 arrays under every HF name of ``model``'s HF counterpart,
    shaped from the port's own parameters (``prefix_fn`` maps a port layer
    name to the HF names and orientations)."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    state = {
        "model.embed_tokens.weight": rng.normal(size=(cfg.vocab_size, cfg.hidden_size)),
        "model.norm.weight": rng.normal(size=(cfg.hidden_size,)),
        "lm_head.weight": rng.normal(size=(cfg.vocab_size, cfg.hidden_size)),
    }
    for l in range(cfg.num_hidden_layers):
        state.update(prefix_fn(f"model.layers.{l}.", rng))
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _mixtral_hf_layer(cfg, names):
    H, D, Hq, Hkv = cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    E, I = cfg.num_experts, cfg.moe_intermediate_size or cfg.intermediate_size
    moe, gate, w1, w2, w3 = names

    def layer(p, rng):
        out = {
            p + "self_attn.q_proj.weight": rng.normal(size=(Hq * D, H)),
            p + "self_attn.k_proj.weight": rng.normal(size=(Hkv * D, H)),
            p + "self_attn.v_proj.weight": rng.normal(size=(Hkv * D, H)),
            p + "self_attn.o_proj.weight": rng.normal(size=(H, Hq * D)),
            p + "input_layernorm.weight": rng.normal(size=(H,)),
            p + "post_attention_layernorm.weight": rng.normal(size=(H,)),
            p + f"{moe}.{gate}.weight": rng.normal(size=(E, H)),
        }
        if cfg.use_qk_norm:
            out[p + "self_attn.q_norm.weight"] = rng.normal(size=(D,))
            out[p + "self_attn.k_norm.weight"] = rng.normal(size=(D,))
        for e in range(E):
            out[p + f"{moe}.experts.{e}.{w1}.weight"] = rng.normal(size=(I, H))
            out[p + f"{moe}.experts.{e}.{w2}.weight"] = rng.normal(size=(H, I))
            out[p + f"{moe}.experts.{e}.{w3}.weight"] = rng.normal(size=(I, H))
        return out

    return layer


@pytest.mark.parametrize("variant", ["mixtral"])
def test_convert_hf_state_matches_jax(variant):
    """A synthetic HF state dict (per-expert ``[out, in]`` matrices): the
    port's state equals ``params_from_jax`` of the JAX package's conversion
    and covers every parameter of the port's model."""
    preset, overrides = VARIANTS[variant]
    arch = overrides["architecture"]
    cfg = get_preset(preset, dtype="float32", **overrides)
    model = get_model_class(arch)(cfg, torch.device("cpu"), torch.float32)
    names = (("block_sparse_moe", "gate", "w1", "w2", "w3") if variant == "mixtral"
             else ("mlp", "gate", "gate_proj", "down_proj", "up_proj"))
    state = synthetic_hf_state(model, _mixtral_hf_layer(cfg, names), seed=3)
    ours = model.convert_hf_state(state)
    jcfg = jax_get_preset(preset, dtype="float32", **overrides)
    jparams = jax_get_model_class(arch)(jcfg).convert_hf_state(state, dtype=jnp.float32)
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert ours.keys() == theirs.keys() == model.state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


# ------------------------------------------------------------ loader and rules


def test_quantized_experts_keep_their_flat_index():
    """A quantized [L * E, In/2, Out] stack whose slices all differ goes
    slice l * E + e to layer l's expert e, and a stack that is no multiple
    of E slices is refused."""
    L, E, In, Out = 3, 4, 64, 48
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 256, (L * E, In // 2, Out), dtype=np.uint8))
    s = torch.from_numpy(rng.random((L * E, 1, Out), dtype=np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.integers(0, 16, (L * E, 1, Out)).astype(np.float32)).to(torch.bfloat16)
    ql = QuantizedLinear(q, s, z, group_size=In)
    state = quantized_layer_state({"w2": ql, "gate_up": ql}, num_experts=E)
    packed = pack_w4(ql)
    for l in range(L):
        for e in range(E):
            for key in ("w2", "gate_up"):
                for part, t in zip("qsz", packed):
                    assert torch.equal(state[f"layers.{l}.{key}.{e}.{part}"], t[l * E + e])
    assert len(state) == 2 * L * E * 3
    with pytest.raises(ValueError, match="experts"):
        quantized_layer_state({"w2": ql}, num_experts=5)


def test_params_from_jax_refuses_a_transposed_down():
    """GPT-OSS's expert ``down`` is [E, I, H]; given [E, H, I] (tiny-gpt-oss:
    hidden 128, intermediate 96) it is refused, and so is a Mixtral ``w2``."""
    for preset, overrides, key in (("tiny-gpt-oss", {}, "down"), ("tiny-debug", MIXTRAL, "w2")):
        jcfg = jax_get_preset(preset, dtype="float32", **overrides)
        cfg = get_preset(preset, dtype="float32", **overrides)
        params = jax.tree.map(np.asarray, jax_get_model_class(cfg.architecture)(jcfg).init_params(
            jax.random.PRNGKey(0), jnp.float32))
        params_from_jax(params, cfg)  # as stored: accepted
        params["layers"][key] = np.swapaxes(params["layers"][key], -1, -2)
        with pytest.raises(ValueError, match=key):
            params_from_jax(params, cfg)
        # the whole pytree transposed is read as such
        with pytest.raises(ValueError):
            params_from_jax(params, cfg, transposed=True)


# Qwen3-30B-A3B's published config.json (huggingface.co/Qwen/Qwen3-30B-A3B)
QWEN3_30B_A3B = dict(
    architectures=["Qwen3MoeForCausalLM"], vocab_size=151936, hidden_size=2048,
    intermediate_size=6144, moe_intermediate_size=768, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, head_dim=128, num_experts=128,
    num_experts_per_tok=8, norm_topk_prob=True, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=40960, tie_word_embeddings=False,
)


@pytest.mark.parametrize("quantization", ["w4a8", "w4a16"])
def test_auto_kv_follows_the_jax_rule_for_moe(quantization):
    """W4 on the card: Qwen3-30B-A3B (the kernel backend, 2048 x 48 = 98,304)
    int8 KV; GPT-OSS-20B (2880 x 24 = 69,120, but no kernel backend in the
    JAX runner: ``supports_pallas_attention`` False) its model dtype."""
    cuda = torch.device("cuda")
    args = ServerArgs(quantization=quantization).resolve()
    qwen = ModelConfig.from_hf_config(QWEN3_30B_A3B)
    assert resolve_kv_cache_dtype(args, qwen, cuda) == "int8"
    assert resolve_kv_cache_dtype(args, get_preset("gpt-oss-20b"), cuda) == "bfloat16"
    # bf16 weights, or the CPU: the model dtype, as before
    assert resolve_kv_cache_dtype(ServerArgs().resolve(), qwen, cuda) == "bfloat16"
    assert resolve_kv_cache_dtype(args, qwen, torch.device("cpu")) == "bfloat16"


def test_moe_refusals():
    """What stays unported is refused with a clear error: toppings on the
    MoE models (no JAX MoE model applies them), fp8 experts, expert
    parallelism, and GPT-OSS under ``attention_backend="pallas"``."""
    small = dict(random_weights=True, dtype="float32", device="cpu", page_size=4,
                 max_total_tokens=256)
    for cfg in (get_preset("tiny-gpt-oss"), get_preset("tiny-debug", **MIXTRAL),
                get_preset("tiny-debug", **QWEN3_MOE)):
        eng = Engine(ServerArgs(**small), model_config=cfg)
        with pytest.raises(NotImplementedError, match="toppings are not ported"):
            eng.register_topping("ad", state={}, scaling=1.0)
        for bad in (dict(quantization="fp8"), dict(enable_ep=True)):
            with pytest.raises(NotImplementedError, match="not ported"):
                Engine(ServerArgs(**small, **bad), model_config=cfg)
    with pytest.raises(NotImplementedError, match="attention_backend='pallas'"):
        Engine(ServerArgs(**small, attention_backend="pallas"), model_config=get_preset("tiny-gpt-oss"))
    # Mixtral takes the pallas decode, as the JAX runner's default allows
    eng = Engine(ServerArgs(**small, attention_backend="pallas"),
                 model_config=get_preset("tiny-debug", **MIXTRAL))
    out = eng.generate(input_ids=[1, 2, 3], sampling_params=SamplingParams(max_new_tokens=3))
    assert len(out.output_ids) == 3
