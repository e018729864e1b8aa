"""Qwen2, Qwen3 and Phi-3 on the port's Llama decoder.

Counterpart of ``scratchpad_tpu/models/qwen.py``: Qwen2 is the Llama decoder
with q, k and v biases, Qwen3 with a per-head RMSNorm on q and k (no
biases), and Phi-3 the Llama decoder whose checkpoints fuse ``qkv_proj`` and
``gate_up_proj``, split here at load (its longrope scaling is in
``compute_inv_freq``). Like the JAX classes, the first two set their flag on
the config they are given.
"""

from __future__ import annotations

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM


class Qwen2ForCausalLM(LlamaForCausalLM):
    def __init__(self, cfg: ModelConfig, *args, **kwargs):
        cfg.attention_bias = True
        super().__init__(cfg, *args, **kwargs)


class Qwen3ForCausalLM(LlamaForCausalLM):
    def __init__(self, cfg: ModelConfig, *args, **kwargs):
        cfg.use_qk_norm = True
        cfg.attention_bias = False
        super().__init__(cfg, *args, **kwargs)


class Phi3ForCausalLM(LlamaForCausalLM):
    def convert_hf_state(self, state: dict, dtype=None):
        """Split the fused ``qkv_proj`` ([q | k | v] along out) and
        ``gate_up_proj`` ([gate | up]) weights, then map as Llama does."""
        cfg = self.cfg
        Hq = cfg.num_attention_heads * cfg.head_dim
        Hkv = cfg.num_kv_heads * cfg.head_dim
        I = cfg.intermediate_size
        out = {}
        for name, w in state.items():
            if name.endswith("self_attn.qkv_proj.weight"):
                out[name.replace("qkv_proj", "q_proj")] = w[:Hq]
                out[name.replace("qkv_proj", "k_proj")] = w[Hq : Hq + Hkv]
                out[name.replace("qkv_proj", "v_proj")] = w[Hq + Hkv :]
            elif name.endswith("mlp.gate_up_proj.weight"):
                out[name.replace("gate_up_proj", "gate_proj")] = w[:I]
                out[name.replace("gate_up_proj", "up_proj")] = w[I:]
            else:
                out[name] = w
        return super().convert_hf_state(out, dtype)
