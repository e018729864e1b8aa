"""Llama family (Llama 2/3.x) as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/llama.py``. The JAX model stacks the
layers' weights on a leading axis and unrolls a functional layer loop; here
each decoder layer is a module in a ``ModuleList`` and the forward loops
over them. Projections are ``nn.Linear`` (HF's ``[out, in]`` weights), so an
HF state dict maps onto the module by renaming alone (``convert_hf_state``).

The forward writes each layer's new K/V into the paged pool, then runs
attention through the CUDA kernel wrappers, which take their plain versions
for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import (
    apply_rope,
    compute_inv_freq,
    rms_norm,
    rope_attention_scale,
    rope_cos_sin,
    silu_mul,
)
from scratchpad_tpu_torch.ops.attention import (
    attention_ragged,
    decode_attention_gqa,
    write_kv,
)


def _linear(n_in: int, n_out: int, bias: bool, device, dtype) -> nn.Linear:
    # parameters are filled by init_random_ or load_state_dict
    return skip_init(nn.Linear, n_in, n_out, bias=bias, device=device, dtype=dtype)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
        b = cfg.attention_bias
        self.input_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.post_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.wq = _linear(H, Hq * D, b, device, dtype)
        self.wk = _linear(H, Hkv * D, b, device, dtype)
        self.wv = _linear(H, Hkv * D, b, device, dtype)
        self.wo = _linear(Hq * D, H, False, device, dtype)
        self.gate = _linear(H, I, False, device, dtype)
        self.up = _linear(H, I, False, device, dtype)
        self.down = _linear(I, H, False, device, dtype)


class LlamaForCausalLM(nn.Module):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        unported = [
            name
            for name, on in (
                ("sliding_window", cfg.sliding_window),
                ("attn_logit_softcap", cfg.attn_logit_softcap),
                ("use_qk_norm", cfg.use_qk_norm),
                ("multimodal", cfg.multimodal),
                ("mrope", (cfg.rope_scaling or {}).get("mrope_section")),
            )
            if on
        ]
        if unported:
            raise NotImplementedError(
                f"Llama options not ported yet: {', '.join(unported)}"
            )
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        self.embed = skip_init(nn.Embedding, V, H, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers)
        )
        self.final_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.lm_head = (
            None if cfg.tie_word_embeddings else _linear(H, V, False, device, dtype)
        )
        self.register_buffer(
            "inv_freq",
            torch.as_tensor(compute_inv_freq(cfg), device=device),
            persistent=False,
        )
        self.sm_scale = float(rope_attention_scale(cfg) / np.sqrt(cfg.head_dim))
        # attention impls; the runner may swap in the plain versions
        self.decode_attention = decode_attention_gqa
        self.extend_attention = attention_ragged

    # ------------------------------------------------------------- parameters

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """Random weights (benchmarks, tests without checkpoints), the JAX
        package's scheme: normal / sqrt(fan_in), norms at one, biases zero."""

        def fill(w: torch.Tensor, fan_in: int) -> None:
            r = torch.randn(
                w.shape, generator=generator, device=w.device, dtype=torch.float32
            )
            w.copy_(r / math.sqrt(fan_in))

        H = self.cfg.hidden_size
        fill(self.embed.weight, H)
        for layer in self.layers:
            layer.input_norm.fill_(1.0)
            layer.post_norm.fill_(1.0)
            for lin in (layer.wq, layer.wk, layer.wv, layer.wo,
                        layer.gate, layer.up, layer.down):
                fill(lin.weight, lin.in_features)
                if lin.bias is not None:
                    lin.bias.zero_()
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            fill(self.lm_head.weight, H)

    HF_LAYER_MAP = {
        "self_attn.q_proj.weight": "wq.weight",
        "self_attn.k_proj.weight": "wk.weight",
        "self_attn.v_proj.weight": "wv.weight",
        "self_attn.o_proj.weight": "wo.weight",
        "self_attn.q_proj.bias": "wq.bias",
        "self_attn.k_proj.bias": "wk.bias",
        "self_attn.v_proj.bias": "wv.bias",
        "mlp.gate_proj.weight": "gate.weight",
        "mlp.up_proj.weight": "up.weight",
        "mlp.down_proj.weight": "down.weight",
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_norm",
    }

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """Map a flat HF state dict (name -> numpy array or tensor) onto this
        module's ``state_dict`` names. HF linear weights are already
        ``[out, in]``, the ``nn.Linear`` orientation."""
        out: dict[str, torch.Tensor] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if dtype is not None:
                t = t.to(dtype)
            if name.startswith("model.layers."):
                idx, sub = name[len("model.layers."):].split(".", 1)
                if sub not in self.HF_LAYER_MAP:
                    raise KeyError(f"unmapped HF weight {name}")
                out[f"layers.{int(idx)}.{self.HF_LAYER_MAP[sub]}"] = t
            elif name == "model.embed_tokens.weight":
                out["embed.weight"] = t
            elif name == "model.norm.weight":
                out["final_norm"] = t
            elif name == "lm_head.weight":
                if not self.cfg.tie_word_embeddings:
                    out["lm_head.weight"] = t
            elif name.endswith("rotary_emb.inv_freq"):
                pass
            else:
                raise KeyError(f"unmapped HF weight {name}")
        return out

    # ---------------------------------------------------------------- forward

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        cfg = self.cfg
        T = meta.num_tokens
        Hq, Hkv, D = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        attend = (
            self.decode_attention
            if meta.mode == ForwardMode.DECODE
            else self.extend_attention
        )
        cos, sin = rope_cos_sin(meta.positions, self.inv_freq)
        x = self.embed(meta.tokens)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.input_norm, eps)
            q = apply_rope(layer.wq(h).view(T, Hq, D), cos, sin)
            k = apply_rope(layer.wk(h).view(T, Hkv, D), cos, sin)
            v = layer.wv(h).view(T, Hkv, D)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(q, kv, l, meta, sm_scale=self.sm_scale)
            x = x + layer.wo(attn.reshape(T, Hq * D))
            h2 = rms_norm(x, layer.post_norm, eps)
            x = x + layer.down(silu_mul(layer.gate(h2), layer.up(h2)))
        h = rms_norm(x, self.final_norm, eps)
        last = h[meta.last_token_idx]  # [B, H]
        head = self.embed.weight if self.lm_head is None else self.lm_head.weight
        logits = (last @ head.T).float()
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits
