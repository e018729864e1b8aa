"""SwissAI Apertus as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/apertus.py``: the Llama decoder's
attention with a per-head weighted RMSNorm on q and k before rope
(``q_norm``, ``k_norm``), and a gateless MLP, ``down(xielu(up(h)))``, whose
xIELU activation holds two learned f32 scalars a layer:

    f(x) = softplus(a_p) x^2 + b x                               for x > 0
           (expm1(min(x, eps)) - x) (b + softplus(a_n)) + b x    otherwise

with b = 0.5 and eps = -1e-6, as the JAX model fixes them (HF keeps them as
bf16 buffers, ``act_fn.beta`` and ``act_fn.eps``, which the conversion
drops). The layer's norms are ``attn_norm`` and ``ffw_norm`` (HF's
``attention_layernorm`` and ``feedforward_layernorm``).

It decodes and extends through the attention kernels under
``attention_backend`` ``auto`` and ``pallas`` (``supports_pallas_attention``,
the JAX runner's default for a class that does not set it). Quantization and
toppings are refused: the JAX forward reads no ``layers_q`` and applies no
adapters. Under tensor parallelism (``tp``) a rank holds its heads and its
columns of up (rows of o and down), as JAX ``apertus.py:87-107`` places
them; the norms and xIELU's two scalars are replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import apply_rope, fill_random, rms_norm, rope_cos_sin, row_parallel_sum
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM, _linear
from scratchpad_tpu_torch.ops.attention import write_kv

BETA = 0.5
EPS = -1e-6
ALPHA_INIT = 0.8  # the JAX init of both scalars


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor) -> torch.Tensor:
    """xIELU in f32 (see the module docstring), cast back to x's dtype."""
    xf = x.float()
    ap = F.softplus(alpha_p.float())
    an = BETA + F.softplus(alpha_n.float())
    pos = ap * xf * xf + BETA * xf
    neg = (torch.expm1(torch.clamp(xf, max=EPS)) - xf) * an + BETA * xf
    return torch.where(xf > 0, pos, neg).to(x.dtype)


class ApertusDecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype, tp_size: int = 1):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = (n // tp_size for n in (cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size))
        param = lambda n, dt=dtype: nn.Parameter(torch.empty(n, device=device, dtype=dt))
        self.attn_norm, self.ffw_norm = param(H), param(H)
        self.q_norm, self.k_norm = param(D), param(D)
        self.wq = _linear(H, Hq * D, False, device, dtype)
        self.wk = _linear(H, Hkv * D, False, device, dtype)
        self.wv = _linear(H, Hkv * D, False, device, dtype)
        self.wo = _linear(Hq * D, H, False, device, dtype)
        self.up = _linear(H, I, False, device, dtype)
        self.down = _linear(I, H, False, device, dtype)
        self.alpha_p, self.alpha_n = param(1, torch.float32), param(1, torch.float32)


class ApertusForCausalLM(LlamaForCausalLM):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token;
    the embedding, the head and the rope table are the Llama model's."""

    supports_pallas_attention = True
    supports_toppings = False
    tp_family = "apertus"

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None):
        if quantization is not None or quantize_lm_head:
            raise NotImplementedError("ApertusForCausalLM options not ported: quantization")
        super().__init__(cfg, device, dtype, tp=tp)

    def _make_layer(self, device, dtype, quantization) -> nn.Module:
        return ApertusDecoderLayer(self.cfg, device, dtype, self.tp_size)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """Random weights, the JAX package's scheme: normal / sqrt(fan_in),
        norms at one, both xIELU scalars at 0.8; a tensor-parallel rank
        keeps its shard of each tp 1 draw (``common.fill_random``)."""
        fill = lambda w, name: fill_random(w, name, generator, self.tp, self.tp_family, self.cfg.vocab_size)
        fill(self.embed.weight, "embed.weight")
        for layer in self.layers:
            for norm in (layer.attn_norm, layer.ffw_norm, layer.q_norm, layer.k_norm):
                norm.fill_(1.0)
            layer.alpha_p.fill_(ALPHA_INIT)
            layer.alpha_n.fill_(ALPHA_INIT)
            for t in ("wq", "wk", "wv", "wo", "up", "down"):
                fill(getattr(layer, t).weight, f"layers.0.{t}.weight")
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            fill(self.lm_head.weight, "lm_head.weight")

    HF_LAYER_MAP = {
        "self_attn.q_proj.weight": "wq.weight",
        "self_attn.k_proj.weight": "wk.weight",
        "self_attn.v_proj.weight": "wv.weight",
        "self_attn.o_proj.weight": "wo.weight",
        "self_attn.q_norm.weight": "q_norm",
        "self_attn.k_norm.weight": "k_norm",
        "mlp.up_proj.weight": "up.weight",
        "mlp.down_proj.weight": "down.weight",
        "mlp.act_fn.alpha_p": "alpha_p",
        "mlp.act_fn.alpha_n": "alpha_n",
        "attention_layernorm.weight": "attn_norm",
        "feedforward_layernorm.weight": "ffw_norm",
    }

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """The Llama mapping with Apertus's names; xIELU's constants
        (``act_fn.beta``, ``act_fn.eps``) are dropped and its scalars kept in
        f32, ``[1]`` each."""
        scalars = ("act_fn.alpha_p", "act_fn.alpha_n")
        rest = {k: v for k, v in state.items() if not k.endswith(scalars + ("act_fn.beta", "act_fn.eps"))}
        out = super().convert_hf_state(rest, dtype)
        alphas = super().convert_hf_state({k: v for k, v in state.items() if k.endswith(scalars)})
        out.update({name: t.float().reshape(1) for name, t in alphas.items()})
        return out

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        cfg = self.cfg
        T = meta.num_tokens
        Hq, Hkv = cfg.num_attention_heads // self.tp_size, cfg.num_kv_heads // self.tp_size
        D, eps = cfg.head_dim, cfg.rms_norm_eps
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        cos, sin = rope_cos_sin(meta.positions, self.inv_freq)
        x = self.lookup(meta.tokens)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.attn_norm, eps)
            q = rms_norm(layer.wq(h).view(T, Hq, D), layer.q_norm, eps)
            k = rms_norm(layer.wk(h).view(T, Hkv, D), layer.k_norm, eps)
            v = layer.wv(h).view(T, Hkv, D)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(q, kv, l, meta, sm_scale=self.sm_scale)
            x = x + row_parallel_sum(layer.wo(attn.reshape(T, Hq * D)), self.tp)
            h2 = rms_norm(x, layer.ffw_norm, eps)
            x = x + row_parallel_sum(layer.down(xielu(layer.up(h2), layer.alpha_p, layer.alpha_n)), self.tp)
        h = rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)
