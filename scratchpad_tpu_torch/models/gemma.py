"""Gemma 2 and Gemma 3 (text) as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/gemma.py``. Where the Llama decoder
differs, as in the JAX model:

- RMSNorm scales by (1 + w) in f32 (``gemma_rms_norm``; checkpoint norms are
  zero-centred), four of them a layer: before and after attention, before
  and after the MLP;
- the embedding is scaled by sqrt(hidden) in the model dtype, the MLP is
  GELU (tanh) and mul, and the head is the embedding (always tied);
- ``sm_scale`` is ``query_pre_attn_scalar ** -0.5``, the attention logits
  and the final logits carry the config's soft caps (Gemma 2);
- local (sliding-window) and global layers: Gemma 2 alternates, starting
  local; Gemma 3 has five local layers to one global (pattern 6), its own
  rope base of 10,000 on the local layers beside ``rope_theta`` on the
  global ones, and a per-head (1 + w) norm on q and k.

The JAX model scans the layers with each layer's window as a traced value
(its global layers carry the sentinel ``1 << 30``); here the layer loop is
Python and each layer hands its own window to the attention call: the
config's ``sliding_window`` on a local layer, None on a global one. The
decode and extend kernels take the window per call, so one launch serves
each layer. Quantization and toppings are refused, as the JAX Gemma has
neither.
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
from scratchpad_tpu_torch.models.common import apply_rope, gelu_mul, rope_cos_sin
from scratchpad_tpu_torch.ops.attention import write_kv

LOCAL_ROPE_THETA = 10000.0  # Gemma 3's local layers


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 scaled by (1 + w), cast back to the input dtype."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def _linear(n_in: int, n_out: int, device, dtype) -> nn.Linear:
    return skip_init(nn.Linear, n_in, n_out, bias=False, device=device, dtype=dtype)


class GemmaDecoderLayer(nn.Module):
    NORMS = ("input_norm", "post_attn_norm", "pre_ffw_norm", "post_ffw_norm")

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
        for name in self.NORMS:
            setattr(self, name, nn.Parameter(torch.empty(H, device=device, dtype=dtype)))
        if cfg.use_qk_norm:
            self.q_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
            self.k_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
        self.wq = _linear(H, Hq * D, device, dtype)
        self.wk = _linear(H, Hkv * D, device, dtype)
        self.wv = _linear(H, Hkv * D, device, dtype)
        self.wo = _linear(Hq * D, H, device, dtype)
        self.gate = _linear(H, I, device, dtype)
        self.up = _linear(H, I, device, dtype)
        self.down = _linear(I, H, device, dtype)


class GemmaForCausalLM(nn.Module):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token."""

    # per-layer windows go to the auto kernels; the runner refuses "pallas"
    supports_pallas_attention = False
    supports_toppings = False

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False):
        super().__init__()
        unported = [
            name
            for name, on in (
                ("quantization", quantization is not None or quantize_lm_head),
                ("multimodal", cfg.multimodal),
            )
            if on
        ]
        if unported:
            raise NotImplementedError(f"Gemma options not ported: {', '.join(unported)}")
        self.cfg = cfg
        H, V, D = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
        self.embed = skip_init(nn.Embedding, V, H, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            GemmaDecoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers)
        )
        self.final_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        scalar = cfg.query_pre_attn_scalar
        self.sm_scale = float(scalar) ** -0.5 if scalar is not None else D**-0.5
        # two rope bases on Gemma 3 (local 10k, global rope_theta), one on Gemma 2
        ar = np.arange(0, D, 2, dtype=np.float64) / D
        inv_global = (1.0 / (cfg.rope_theta**ar)).astype(np.float32)
        if cfg.rope_scaling and cfg.rope_scaling.get("factor"):
            inv_global /= cfg.rope_scaling["factor"]
        base_local = LOCAL_ROPE_THETA if self.is_gemma3 else cfg.rope_theta
        inv_local = (1.0 / (base_local**ar)).astype(np.float32)
        for name, inv in (("inv_freq_global", inv_global), ("inv_freq_local", inv_local)):
            self.register_buffer(name, torch.as_tensor(inv, device=device), persistent=False)
        self.decode_attention = None  # set by the runner from attention_backend
        self.extend_attention = None
        self.toppings = None

    @property
    def is_gemma3(self) -> bool:
        return "Gemma3" in self.cfg.architecture

    def is_local_layer(self, l: int) -> bool:
        if self.is_gemma3:
            pattern = self.cfg.sliding_window_pattern or 6
            return (l + 1) % pattern != 0  # five local to one global
        return l % 2 == 0  # Gemma 2 alternates, starting local

    def layer_windows(self) -> list:
        """Each layer's window, None on a global layer (read from the config
        at each forward, as the JAX model does)."""
        w = self.cfg.sliding_window or None
        return [w if self.is_local_layer(l) else None for l in range(len(self.layers))]

    # ------------------------------------------------------------- parameters

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """Random weights, the JAX package's scheme: normal / sqrt(fan_in),
        norms at zero (a scale of one)."""

        def fill(w: torch.Tensor, fan_in: int) -> None:
            r = torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
            w.copy_(r / math.sqrt(fan_in))

        fill(self.embed.weight, self.cfg.hidden_size)
        for layer in self.layers:
            for name, p in layer.named_parameters():
                if name.endswith("norm"):
                    p.zero_()
            for lin in (layer.wq, layer.wk, layer.wv, layer.wo, layer.gate, layer.up, layer.down):
                fill(lin.weight, lin.in_features)
        self.final_norm.zero_()

    HF_LAYER_MAP = {
        "self_attn.q_proj.weight": "wq.weight",
        "self_attn.k_proj.weight": "wk.weight",
        "self_attn.v_proj.weight": "wv.weight",
        "self_attn.o_proj.weight": "wo.weight",
        "self_attn.q_norm.weight": "q_norm",
        "self_attn.k_norm.weight": "k_norm",
        "mlp.gate_proj.weight": "gate.weight",
        "mlp.up_proj.weight": "up.weight",
        "mlp.down_proj.weight": "down.weight",
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_attn_norm",
        "pre_feedforward_layernorm.weight": "pre_ffw_norm",
        "post_feedforward_layernorm.weight": "post_ffw_norm",
    }

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """Map a flat HF state dict onto this module's ``state_dict`` names;
        an ``lm_head.weight`` is skipped (Gemma ties its head)."""
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
            elif name == "lm_head.weight" or name.endswith("rotary_emb.inv_freq"):
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
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        rope = {
            True: rope_cos_sin(meta.positions, self.inv_freq_local),
            False: rope_cos_sin(meta.positions, self.inv_freq_global),
        }
        x = self.embed(meta.tokens)  # [T, H]
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype)
        for l, (layer, window) in enumerate(zip(self.layers, self.layer_windows())):
            h = gemma_rms_norm(x, layer.input_norm, eps)
            q = layer.wq(h).view(T, Hq, D)
            k = layer.wk(h).view(T, Hkv, D)
            v = layer.wv(h).view(T, Hkv, D)
            if cfg.use_qk_norm:
                q = gemma_rms_norm(q, layer.q_norm, eps)
                k = gemma_rms_norm(k, layer.k_norm, eps)
            cos, sin = rope[self.is_local_layer(l)]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(
                q, kv, l, meta, sm_scale=self.sm_scale,
                logit_cap=cfg.attn_logit_softcap, sliding_window=window,
            )
            x = x + gemma_rms_norm(layer.wo(attn.reshape(T, Hq * D)), layer.post_attn_norm, eps)
            h2 = gemma_rms_norm(x, layer.pre_ffw_norm, eps)
            mlp = layer.down(gelu_mul(layer.gate(h2), layer.up(h2)))
            x = x + gemma_rms_norm(mlp, layer.post_ffw_norm, eps)
        h = gemma_rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-normed rows ``h`` [N, H] through the tied head,
        soft-capped where the model caps them."""
        logits = (h @ self.embed.weight.T).float()
        cap = self.cfg.logit_softcap
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits


class Gemma2ForCausalLM(GemmaForCausalLM):
    pass


class Gemma3ForCausalLM(GemmaForCausalLM):
    def __init__(self, cfg: ModelConfig, *args, **kwargs):
        cfg.use_qk_norm = True
        super().__init__(cfg, *args, **kwargs)
