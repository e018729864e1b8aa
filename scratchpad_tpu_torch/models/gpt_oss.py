"""GPT-OSS (OpenAI's open-weight MoE, 20B and 120B) as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/gpt_oss.py``, on the MoE decoder of
``models/mixtral.py``. Where it differs from Mixtral, as in the JAX model:

- sliding-window (``sliding_attention``) and global layers in turn, from
  HF's ``layer_types`` or, without them, local on even layers (``:75-92``);
  each layer hands its own window to the attention call, None on a global
  layer (the JAX model passes the sentinel ``1 << 30``);
- attention sinks: a learned logit per query head (``sinks [Hq]`` a layer,
  cast to f32 at the call) that joins the softmax and carries no value;
  the decode and extend kernels take them;
- biases on q, k, v and o, on the router and on every expert;
- ``sm_scale = rope_attention_scale / sqrt(head_dim)`` (YaRN's mscale^2,
  ``:68``);
- routing: top-k of the router logits, then softmax over those k
  (``:217-223``);
- experts: one interleaved gate|up matrix ``[H, 2I]`` (gate the even
  columns, up the odd ones), gate clamped above at 7, up to [-7, 7],
  ``(up + 1) * gate * sigmoid(1.702 gate)``, then down ``[I, H]`` and its
  bias (``:229-251``), masked and dense over all experts as Mixtral's.

The port's Llama names a fused gate|up ``gate_up`` too; here ``gate_up`` is
the interleaved expert stack (``[E, H, 2I]``, or ``gate_up.{e}`` when
quantized), with its bias ``gate_up_b [E, 2I]`` beside it. Quantized, the
biases stay in the model dtype and are added after the 4-bit GEMM, as the
JAX model adds them (``:235``, ``:247``). The runner refuses
``attention_backend="pallas"`` for it (``supports_pallas_attention``
False), as the JAX runner sends it to XLA.

Under tensor parallelism (``tp``) a rank holds its heads (q, k, v and
their biases by column, o by row), and the experts, the router, their
biases, o's bias and the sinks whole, as the JAX spec places them
(``gpt_oss.py:140-163``): every rank runs every expert on the same hidden
state, so the MoE needs no collective (``MOE_SUM`` False), o's bias is
added once after o's sum, and each rank hands the kernels the sinks of its
own heads.
"""

from __future__ import annotations

import torch
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.models.common import rope_attention_scale
from scratchpad_tpu_torch.models.llama import _linear
from scratchpad_tpu_torch.ops.quant.fp8 import Fp8ExpertStack
from scratchpad_tpu_torch.models.mixtral import (
    MoeForCausalLM,
    expert_stack,
    routing_weights,
    weighted_sum,
)

ALPHA = 1.702
LIMIT = 7.0


def clamped_swiglu(gu: torch.Tensor) -> torch.Tensor:
    """GPT-OSS's activation of an interleaved gate|up ``gu [..., 2I]``: gate
    the even columns clamped above at ``LIMIT``, up the odd ones clamped to
    +-``LIMIT``, ``(up + 1) * gate * sigmoid(ALPHA gate)``."""
    gate = gu[..., 0::2].clamp(max=LIMIT)
    up = gu[..., 1::2].clamp(-LIMIT, LIMIT)
    return (up + 1.0) * (gate * torch.sigmoid(gate * ALPHA))
# the sinks' random init: N(0, SINK_STD^2), not the JAX package's zeros, so
# that a check can see them
SINK_STD = 2.0


class GptOssForCausalLM(MoeForCausalLM):
    supports_pallas_attention = False  # per-layer windows and sinks
    tp_family = "gpt_oss"
    ATTN_BIAS = True
    EXPERT_STACKS = ("gate_up", "down")
    BIASES = ("gate_up_b", "down_b")
    MOE_SUM = False  # every rank holds every expert

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None):
        super().__init__(cfg, device, dtype, quantization, quantize_lm_head, tp)
        self.sm_scale = float(rope_attention_scale(cfg) / cfg.head_dim**0.5)

    def _add_experts(self, layer, device, dtype) -> None:
        cfg = self.cfg
        H, E, I, Hq = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size, cfg.num_attention_heads
        layer.sinks = nn.Parameter(torch.empty(Hq, device=device, dtype=dtype))
        layer.router = _linear(H, E, True, device, dtype)
        layer.gate_up = expert_stack(E, H, 2 * I, self.quantization, device, dtype)
        layer.gate_up_b = nn.Parameter(torch.empty(E, 2 * I, device=device, dtype=dtype))
        layer.down = expert_stack(E, I, H, self.quantization, device, dtype)
        layer.down_b = nn.Parameter(torch.empty(E, H, device=device, dtype=dtype))

    def _init_extra_(self, name, p, generator, place=None) -> None:
        if not name.endswith(".sinks"):
            return super()._init_extra_(name, p, generator, place)
        r = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
        if place is not None:
            place(name, r * SINK_STD)
        else:
            p.copy_(r * SINK_STD)

    def layer_windows(self) -> list:
        """Each layer's window, None on a global layer (read from the config
        at each forward, as the JAX model does)."""
        cfg = self.cfg
        L = cfg.num_hidden_layers
        kinds = cfg.layer_types or [
            "sliding_attention" if l % 2 == 0 else "full_attention" for l in range(L)
        ]
        w = cfg.sliding_window or None
        return [w if kind == "sliding_attention" else None for kind in kinds]

    def attention_kwargs(self, l, layer) -> dict:
        sinks = layer.sinks  # [Hq], whole on every rank: the rank's heads' entries
        if self.tp is not None:
            n = sinks.shape[0] // self.tp_size
            sinks = sinks[self.tp.rank * n : (self.tp.rank + 1) * n]
        return dict(sliding_window=self.layer_windows()[l], sinks=sinks.float())

    def _moe(self, h: torch.Tensor, layer) -> torch.Tensor:
        """Top-k then softmax over the k, and the clamped interleaved
        SwiGLU experts, masked and dense (``gpt_oss.py:217-251``)."""
        E = self.cfg.num_experts
        logits = layer.router(h).float()  # [T, E]
        topi = self.top_experts(logits)
        w = routing_weights(torch.softmax(logits.gather(1, topi), dim=-1), topi, E, h.dtype)
        if isinstance(layer.gate_up, Fp8ExpertStack):  # fp8 stacks: all experts at once
            gu = layer.gate_up(h) + layer.gate_up_b[:, None]  # [E, T, 2I]
            return weighted_sum(layer.down(clamped_swiglu(gu)) + layer.down_b[:, None], w)
        if not isinstance(layer.gate_up, nn.ModuleList):  # bf16 stacks: all experts at once
            gu = torch.matmul(h, layer.gate_up) + layer.gate_up_b[:, None]  # [E, T, 2I]
            out = torch.matmul(clamped_swiglu(gu), layer.down) + layer.down_b[:, None]
            return weighted_sum(out, w)
        y = torch.zeros_like(h)  # 4-bit: one GEMM an expert and matrix
        for e in range(E):
            act = clamped_swiglu(layer.gate_up[e](h) + layer.gate_up_b[e])
            y = y + (layer.down[e](act) + layer.down_b[e]) * w[:, e : e + 1]
        return y

    HF_LAYER_MAP = {
        "self_attn.q_proj.bias": "wq.bias",
        "self_attn.k_proj.bias": "wk.bias",
        "self_attn.v_proj.bias": "wv.bias",
        "self_attn.o_proj.bias": "wo.bias",
        "self_attn.sinks": "sinks",
        "mlp.router.weight": "router.weight",
        "mlp.router.bias": "router.bias",
        # the expert stacks are [E, In, Out] in HF as here
        "mlp.experts.gate_up_proj": "gate_up",
        "mlp.experts.gate_up_proj_bias": "gate_up_b",
        "mlp.experts.down_proj": "down",
        "mlp.experts.down_proj_bias": "down_b",
    }

    def _convert_layer(self, l, sub, t, out, experts) -> bool:
        if super()._convert_layer(l, sub, t, out, experts):
            return True
        if sub in self.HF_LAYER_MAP:
            out[f"layers.{l}.{self.HF_LAYER_MAP[sub]}"] = t
            return True
        return False
