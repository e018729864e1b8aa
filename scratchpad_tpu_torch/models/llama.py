"""Llama family (Llama 2/3.x, Mistral) as a PyTorch ``nn.Module``.

Counterpart of ``scratchpad_tpu/models/llama.py``. The JAX model stacks the
layers' weights on a leading axis and unrolls a functional layer loop; here
each decoder layer is a module in a ``ModuleList`` and the forward loops
over them. Projections are ``nn.Linear`` (HF's ``[out, in]`` weights), so an
HF state dict maps onto the module by renaming alone (``convert_hf_state``);
a quantized model holds ``QuantLinear`` layers instead.

The forward writes each layer's new K/V into the paged pool, then runs
attention (with the config's uniform ``sliding_window`` and
``attn_logit_softcap``, as the JAX forward passes them) and the 4-bit
projections through the CUDA kernel wrappers, which take their plain
versions for CPU tensors. The runner sets the model's decode and extend
attention functions from ``attention_backend``. With toppings attached
(``self.toppings``, the manager's device pools) and a batch that names
adapters, each projection's output gains its tokens' own adapters
(``apply_topping``); a batch that names none skips that path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.quant.w4_matmul import pack_w4
from scratchpad_tpu_torch.ops.quant.w4a16 import (
    quantize_model_params,
    quantize_stacked,
    stacked_group_size,
    stacked_out_width,
)
from scratchpad_tpu_torch.models.common import (
    QuantLinear,
    apply_rope,
    compute_inv_freq,
    rms_norm,
    rope_attention_scale,
    rope_cos_sin,
    silu_mul,
)
from scratchpad_tpu_torch.ops.attention import write_kv
from scratchpad_tpu_torch.toppings.manager import apply_topping


def _linear(n_in: int, n_out: int, bias: bool, device, dtype) -> nn.Linear:
    # parameters are filled by init_random_ or load_state_dict
    return skip_init(nn.Linear, n_in, n_out, bias=bias, device=device, dtype=dtype)


def _quant_linear(n_in: int, n_out: int, a8: bool, bias: bool, device, dtype) -> QuantLinear:
    # the shapes quantize_stacked gives a weight [n_in, n_out]; filled by
    # load_state_dict
    stored, _ = stacked_out_width(n_out)
    return QuantLinear(n_in, n_out, stacked_group_size(n_in), stored, a8, bias, device, dtype)


class LlamaDecoderLayer(nn.Module):
    """``quantization`` set: every projection is a ``QuantLinear``, gate and
    up fused into one ``gate_up`` (gate | up along Out), as the JAX
    package's ``quantize_model_params(fuse_gate_up=True)`` stores them."""

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
        b = cfg.attention_bias
        self.input_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.post_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.fused_gate_up = quantization is not None
        if quantization is None:
            lin = lambda n_in, n_out, bias: _linear(n_in, n_out, bias, device, dtype)
        else:
            a8 = quantization == "w4a8"
            lin = lambda n_in, n_out, bias: _quant_linear(n_in, n_out, a8, bias, device, dtype)
        self.wq = lin(H, Hq * D, b)
        self.wk = lin(H, Hkv * D, b)
        self.wv = lin(H, Hkv * D, b)
        self.wo = lin(Hq * D, H, False)
        if self.fused_gate_up:
            self.gate_up = lin(H, 2 * I, False)
        else:
            self.gate = lin(H, I, False)
            self.up = lin(H, I, False)
        self.down = lin(I, H, False)


class LlamaForCausalLM(nn.Module):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token.

    ``quantization`` (w4a8, or w4a16 and its aliases) builds the decoder's
    projections as ``QuantLinear``; ``quantize_lm_head`` adds ``lm_head_q``,
    a 4-bit copy of the head (``embed.T`` when tied; an untied ``lm_head``
    is then dropped), while ``embed`` stays in the model dtype for lookups.
    The quantized state comes from ``quantize_state`` or from the JAX
    package's parameters (``weight_loader.params_from_jax``)."""

    # the runner may serve it through attention_backend="pallas"
    supports_pallas_attention = True

    def __init__(
        self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False
    ):
        super().__init__()
        unported = [
            name
            for name, on in (
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
            LlamaDecoderLayer(cfg, device, dtype, quantization)
            for _ in range(cfg.num_hidden_layers)
        )
        self.final_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.lm_head = (
            None
            if cfg.tie_word_embeddings or quantize_lm_head
            else _linear(H, V, False, device, dtype)
        )
        self.lm_head_q = (
            _quant_linear(H, V, quantization == "w4a8", False, device, dtype)
            if quantize_lm_head
            else None
        )
        self.register_buffer(
            "inv_freq",
            torch.as_tensor(compute_inv_freq(cfg), device=device),
            persistent=False,
        )
        self.sm_scale = float(rope_attention_scale(cfg) / np.sqrt(cfg.head_dim))
        # attention impls (the model-facing functions of ops.attention), set
        # by the runner from attention_backend
        self.decode_attention = None
        self.extend_attention = None
        self.toppings = None  # ToppingsManager.device_pools(), set by the runner

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

    def quantize_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This quantized model's ``state_dict`` from the ``state_dict`` of
        its unquantized twin: each layer's ``[out, in]`` weights, transposed
        to ``[in, out]`` so that groups run along In, go through the JAX
        package's ``quantize_model_params(fuse_gate_up=True)`` (copied,
        bit-identical codes) and ``pack_w4``; the head through
        ``quantize_stacked``. Layers that arrive quantized (an imported int4
        checkpoint) are kept as they are. Quantization runs in host numpy;
        the packing runs on this model's device."""
        device = self.final_norm.device
        state = dict(state)

        def packed(ql) -> tuple[torch.Tensor, ...]:
            ql = dataclasses.replace(ql, q=ql.q.to(device), s=ql.s.to(device), z=ql.z.to(device))
            return tuple(t[0] for t in pack_w4(ql))

        def host_in_out(w: torch.Tensor) -> np.ndarray:
            return w.float().cpu().numpy().T[None]  # [1, in, out]

        if self.layers[0].fused_gate_up and "layers.0.wq.weight" in state:
            for l in range(len(self.layers)):
                dense = {
                    t: host_in_out(state.pop(f"layers.{l}.{t}.weight"))
                    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down")
                }
                for t, ql in quantize_model_params(dense, fuse_gate_up=True).items():
                    name = "gate_up" if t == "gate_up_f" else t
                    for key, v in zip("qsz", packed(ql)):
                        state[f"layers.{l}.{name}.{key}"] = v
        if self.lm_head_q is not None:
            head = state["embed.weight"] if self.cfg.tie_word_embeddings else state.pop("lm_head.weight")
            for key, v in zip("qsz", packed(quantize_stacked(host_in_out(head)))):
                state[f"lm_head_q.{key}"] = v
        return state

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
        use_toppings = self.toppings is not None and meta.active_adapters is not None
        if use_toppings:
            token_slot = meta.adapter_slots[meta.req_indices]  # i32[T]

        def topped(y, h, name, l):
            """y + each token's own adapter on projection ``name``."""
            if not use_toppings:
                return y
            return apply_topping(h, y, self.toppings, name, l, meta.active_adapters, token_slot)

        def lin(layer, name, h, l):
            return topped(getattr(layer, name)(h), h, name, l)

        x = self.embed(meta.tokens)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.input_norm, eps)
            q = apply_rope(lin(layer, "wq", h, l).view(T, Hq, D), cos, sin)
            k = apply_rope(lin(layer, "wk", h, l).view(T, Hkv, D), cos, sin)
            v = lin(layer, "wv", h, l).view(T, Hkv, D)
            write_kv(kv, k, v, l, meta.out_cache_loc)
            attn = attend(
                q, kv, l, meta, sm_scale=self.sm_scale,
                logit_cap=cfg.attn_logit_softcap, sliding_window=cfg.sliding_window,
            )
            x = x + lin(layer, "wo", attn.reshape(T, Hq * D), l)
            h2 = rms_norm(x, layer.post_norm, eps)
            if layer.fused_gate_up:
                # the pools keep gate and up apart: each half gets its own
                gate, up = layer.gate_up(h2).chunk(2, dim=-1)
                gate, up = topped(gate, h2, "gate", l), topped(up, h2, "up", l)
            else:
                gate, up = lin(layer, "gate", h2, l), lin(layer, "up", h2, l)
            x = x + lin(layer, "down", silu_mul(gate, up), l)
        h = rms_norm(x, self.final_norm, eps)
        last = h[meta.last_token_idx]  # [B, H]
        if self.lm_head_q is not None:
            logits = self.lm_head_q(last).float()
        else:
            head = self.embed.weight if self.lm_head is None else self.lm_head.weight
            logits = (last @ head.T).float()
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits
