"""Llama-4's text decoder (Scout, Maverick) as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/llama4.py``, on the MoE decoder of
``models/mixtral.py``. Where it differs from Llama-3, as in the JAX model:

- interleaved-pair (complex) rope (``apply_rope_interleaved``, Llama-3
  scaling through ``compute_inv_freq``) on the layers whose
  ``no_rope_layers`` entry is 1, then, with ``use_qk_norm``, an L2 norm of q
  and k (a unit-weight RMSNorm, no parameters);
- on the NoPE layers (entry 0) no rope, and with ``attn_temperature_tuning``
  q scaled by ``log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1``,
  computed in f32 and cast back to q's dtype (``:237-243``, ``:260-261``);
- the rope layers attend within chunks of ``attention_chunk_size``
  (``chunk_size`` of both attention kernels), the NoPE layers globally
  (``:263-267``);
- the layers of ``moe_layers`` (by default every
  ``interleave_moe_layer_step``-th, ``:64-69``) are MoE: the router takes
  the top-k of its logits and a sigmoid of each picked logit, zero for
  every other expert; the weights scale each expert's input; a shared
  SwiGLU expert always adds in (``:198-221``). The experts run masked and
  dense as Mixtral's, bf16 stacks ``[E, In, Out]`` in one batched matmul a
  matrix over the weighted inputs ``[E, T, H]``. The other layers are a
  SwiGLU MLP ``intermediate_size_mlp`` wide (``gate``, ``up``, ``down_d``).

The dense and MoE layers differ in their parameters, so the layers are a
``ModuleList`` of two kinds, and the JAX parameters a list of per-layer
dicts (``weight_loader.params_from_jax`` takes both forms). The config copy
derives ``no_rope_layers`` as HF does where it is left out or empty (every
fourth layer NoPE), where the JAX copy makes every layer a rope layer.

The runner decodes it through the decode kernel and extends it through the
extend kernel, each with the chunk (the JAX package extends it in XLA: the
extend branch is the port's own); ``attention_backend="pallas"`` is refused
(``supports_pallas_attention`` False), and so are quantization and toppings
(the JAX forward reads no ``layers_q`` and applies no adapters). An 8-bit KV
pool (``kv_cache_dtype`` int8 or fp8) runs both kernels' 8-bit branches.

Under tensor parallelism (``tp``) a rank holds its heads, its rows of o,
its share of the dense MLP, of the shared expert and of each expert's width
(JAX ``llama4.py:122-150``). The fused ``gate_up`` stack ``[E, H, 2I]`` is
read as gate ``[..., :I]`` and up ``[..., I:]``, so a rank's shard holds its
share of the gate columns, then its share of the up columns
(``parallel.HALVES``): a plain cut of the fused axis would give rank 0
gate columns only. The routed and the shared experts' partial sums are
added before the layer's one MoE collective.
"""

from __future__ import annotations

import torch
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import (
    apply_rope_interleaved,
    rms_norm,
    rope_cos_sin,
    row_parallel_sum,
    silu_mul,
    vocab_lookup,
)
from scratchpad_tpu_torch.models.llama import _linear
from scratchpad_tpu_torch.models.mixtral import (
    MoeDecoderLayer,
    MoeForCausalLM,
    expert_stack,
    routing_weights,
)
from scratchpad_tpu_torch.ops.attention import write_kv


def moe_layer_ids(cfg: ModelConfig) -> set[int]:
    """The MoE layers: ``moe_layers``, or every
    ``interleave_moe_layer_step``-th layer (all of them at step 1)."""
    if cfg.moe_layers is not None:
        return set(cfg.moe_layers)
    step = cfg.interleave_moe_layer_step or 1
    return set(range(step - 1, cfg.num_hidden_layers, step))


def l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm without a weight, in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


class Llama4ForCausalLM(MoeForCausalLM):
    supports_pallas_attention = False  # per-layer chunked and global masks
    tp_family = "llama4"
    EXPERT_STACKS = ("gate_up", "down")

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None):
        if quantization is not None or quantize_lm_head:
            raise NotImplementedError("Llama4ForCausalLM options not ported: quantization")
        super().__init__(cfg, device, dtype, tp=tp)
        L = cfg.num_hidden_layers
        if len(cfg.no_rope_layers) != L:
            raise ValueError(f"no_rope_layers has {len(cfg.no_rope_layers)} entries for {L} layers")
        self.use_rope = [bool(r) for r in cfg.no_rope_layers]
        # each layer's chunk: the rope layers' attention_chunk_size, None on
        # the NoPE layers
        self.layer_chunks = [
            cfg.attention_chunk_size if rope and cfg.attention_chunk_size else None
            for rope in self.use_rope
        ]

    def _make_layer(self, l: int, device, dtype) -> MoeDecoderLayer:
        """Attention (no qk-norm weights: the L2 norm has none), then the
        router, the expert stacks and the shared expert (``moe``), or the
        dense MLP."""
        cfg, n = self.cfg, self.tp_size
        H, E, I = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size // n
        layer = MoeDecoderLayer(cfg, device, dtype, None, False, qk_norm=False, tp=self.tp)
        layer.moe = l in moe_layer_ids(cfg)
        lin = lambda n_in, n_out: _linear(n_in, n_out, False, device, dtype)
        if layer.moe:
            layer.router = lin(H, E)
            layer.gate_up = expert_stack(E, H, 2 * I, None, device, dtype)
            layer.down = expert_stack(E, I, H, None, device, dtype)
            layer.s_gate, layer.s_up, layer.s_down = lin(H, I), lin(H, I), lin(I, H)
        else:
            Im = (cfg.intermediate_size_mlp or cfg.intermediate_size) // n
            layer.gate, layer.up, layer.down_d = lin(H, Im), lin(H, Im), lin(Im, H)
        return layer

    def _moe(self, h: torch.Tensor, layer) -> torch.Tensor:
        """Top-k, a sigmoid of the picked logits, the weights on each
        expert's input; masked and dense, with the shared expert
        (``llama4.py:198-221``); under tensor parallelism a rank's partial
        sum of both."""
        E = self.cfg.num_experts
        logits = layer.router(h).float()  # [T, E]
        topi = self.top_experts(logits)
        w = routing_weights(torch.sigmoid(logits.gather(1, topi)), topi, E, h.dtype)
        y = layer.s_down(silu_mul(layer.s_gate(h), layer.s_up(h)))
        gu = torch.matmul(h[None] * w.T[:, :, None], layer.gate_up)  # [E, T, 2I]
        out = torch.matmul(silu_mul(*gu.chunk(2, dim=-1)), layer.down)  # [E, T, H]
        return y + out.sum(dim=0)

    HF_LAYER_MAP = {
        "feed_forward.router.weight": "router.weight",
        # the expert stacks are [E, In, Out] in HF as here
        "feed_forward.experts.gate_up_proj": "gate_up",
        "feed_forward.experts.down_proj": "down",
        "feed_forward.shared_expert.gate_proj.weight": "s_gate.weight",
        "feed_forward.shared_expert.up_proj.weight": "s_up.weight",
        "feed_forward.shared_expert.down_proj.weight": "s_down.weight",
        "feed_forward.gate_proj.weight": "gate.weight",
        "feed_forward.up_proj.weight": "up.weight",
        "feed_forward.down_proj.weight": "down_d.weight",
    }

    def _convert_layer(self, l, sub, t, out, experts) -> bool:
        if super()._convert_layer(l, sub, t, out, experts):
            return True
        if sub in self.HF_LAYER_MAP:
            out[f"layers.{l}.{self.HF_LAYER_MAP[sub]}"] = t
            return True
        return False

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        cfg = self.cfg
        T = meta.num_tokens
        Hq, Hkv = cfg.num_attention_heads // self.tp_size, cfg.num_kv_heads // self.tp_size
        D, eps = cfg.head_dim, cfg.rms_norm_eps
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        cos, sin = rope_cos_sin(meta.positions, self.inv_freq)
        # the NoPE layers' temperature, by position
        temp = (
            torch.log1p(torch.floor((meta.positions.float() + 1.0) / cfg.floor_scale)) * cfg.attn_scale
            + 1.0
        )[:, None, None]
        x = vocab_lookup(self.embed, meta.tokens, self.tp)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.input_norm, eps)
            q = layer.wq(h).view(T, Hq, D)
            k = layer.wk(h).view(T, Hkv, D)
            v = layer.wv(h).view(T, Hkv, D)
            if self.use_rope[l]:
                q, k = apply_rope_interleaved(q, cos, sin), apply_rope_interleaved(k, cos, sin)
                if cfg.use_qk_norm:
                    q, k = l2_norm(q, eps), l2_norm(k, eps)
            elif cfg.attn_temperature_tuning:
                q = (q * temp).to(q.dtype)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(q, kv, l, meta, sm_scale=self.sm_scale, chunk_size=self.layer_chunks[l])
            x = x + self.o_proj(layer, attn.reshape(T, Hq * D))
            h2 = rms_norm(x, layer.post_norm, eps)
            if layer.moe:
                x = x + self.moe_sum(self._moe(h2, layer))
            else:
                x = x + row_parallel_sum(layer.down_d(silu_mul(layer.gate(h2), layer.up(h2))), self.tp)
        h = rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)
