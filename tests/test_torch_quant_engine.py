"""The port's Engine with 4-bit weights against the JAX package's, on the
CPU: the JAX runner quantizes its random tiny-debug init (f32, fused
gate|up, 4-bit head) and the port loads those codes; the same requests give
the same greedy tokens, for W4A8 and W4A16. The request set and the margin
check are ``test_torch_engine.py``'s.
"""

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.ops.quant import import_hf as jax_import_hf
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import ARGS, _greedy_tokens_match
from test_torch_quant import assert_same_codes
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module", params=["w4a8", "w4a16"])
def quant_engines(request):
    """Both engines with 4-bit weights: the JAX runner quantizes its random
    init (fused gate|up, 4-bit head) and the port loads those codes."""
    jeng = JaxEngine(JaxServerArgs(quantization=request.param, **ARGS))
    eng = Engine(ServerArgs(device="cpu", quantization=request.param, **ARGS))
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng, params


def test_quantized_greedy_tokens_match_jax(quant_engines):
    """As the unquantized test, but random 4-bit weights leave near ties
    on these fixed prompts (W4A16 has a step with a top-2 margin of 4.7e-5):
    the tokens must agree up to the first step whose margin is at most
    MARGIN, where f32 rounding may rightly pick the other token."""
    jeng, eng, _ = quant_engines
    _greedy_tokens_match(jeng, eng, stop_at_tie=True)


def test_quantized_weights_load_code_for_code(quant_engines):
    """``params_from_jax`` carries the JAX runner's ``layers_q`` (with the
    fused ``gate_up_f``) and ``lm_head_q``; the port's buffers unpack to the
    same codes, scales and zeros."""
    _, eng, params = quant_engines
    model = eng.scheduler.runner.model
    assert set(params["layers_q"]) == {"wq", "wk", "wv", "wo", "gate_up_f", "down"}
    assert "lm_head" not in params  # the untied head was quantized and dropped
    stacks = dict(params["layers_q"], gate_up=params["layers_q"]["gate_up_f"])
    for l, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo", "gate_up", "down"):
            assert_same_codes(getattr(layer, name), stacks[name], l)
    assert_same_codes(model.lm_head_q, params["lm_head_q"], 0)


class _Tokenizer:
    eos_token_id = 0
    chat_template = None

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


def _awq_checkpoint(path, cfg):
    """A tiny-debug AutoAWQ checkpoint: group 16 (the port's layers are
    built for 32 and take the state's), fp16 scales that bf16 holds exactly
    (the port stores scales in bf16, the JAX package in the model dtype), an
    untied f32 head."""
    rng = np.random.default_rng(5)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    Hq, Hkv = cfg.num_attention_heads, cfg.num_kv_heads
    shapes = {
        "self_attn.q_proj": (H, Hq * D), "self_attn.k_proj": (H, Hkv * D),
        "self_attn.v_proj": (H, Hkv * D), "self_attn.o_proj": (Hq * D, H),
        "mlp.gate_proj": (H, I), "mlp.up_proj": (H, I), "mlp.down_proj": (I, H),
    }
    state = {}
    for l in range(cfg.num_hidden_layers):
        pre = f"model.layers.{l}"
        for sub, (In, Out) in shapes.items():
            q = rng.integers(0, 16, (In, Out)).astype(np.uint8)
            z = rng.integers(1, 15, (In // 16, Out)).astype(np.float32)
            s = torch.from_numpy(rng.uniform(0.5e-3, 5e-3, (In // 16, Out)).astype(np.float32))
            s = s.to(torch.bfloat16).to(torch.float16).numpy()
            qw, qz, sc = jax_import_hf.pack_awq(q, z, s)
            state.update({f"{pre}.{sub}.qweight": qw, f"{pre}.{sub}.qzeros": qz, f"{pre}.{sub}.scales": sc})
        state[f"{pre}.input_layernorm.weight"] = np.ones(H, np.float32)
        state[f"{pre}.post_attention_layernorm.weight"] = np.ones(H, np.float32)
    state["model.embed_tokens.weight"] = rng.standard_normal((cfg.vocab_size, H)).astype(np.float32)
    state["model.norm.weight"] = np.ones(H, np.float32)
    state["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, H)).astype(np.float32) * 0.05
    save_file(state, str(path / "model.safetensors"))


def test_awq_checkpoint_serves_like_jax(tmp_path):
    """The runner's checkpoint path: an AutoAWQ checkpoint on disk is
    imported by both engines (its layers as they are, the head quantized at
    load), and the same requests give the same greedy tokens."""
    args = dict(ARGS, random_weights=False, model_path=str(tmp_path), quantization="awq")
    _awq_checkpoint(tmp_path, get_preset("tiny-debug"))
    jeng = JaxEngine(JaxServerArgs(**args), tokenizer=_Tokenizer())
    eng = Engine(ServerArgs(device="cpu", **args), tokenizer=_Tokenizer())
    layer = eng.scheduler.runner.model.layers[0]
    assert layer.gate_up.group_size == 16 and eng.scheduler.runner.model.lm_head_q is not None
    _greedy_tokens_match(jeng, eng, stop_at_tie=True)
