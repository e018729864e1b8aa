"""Llama family (Llama 2/3.x, Mistral; Qwen2, Qwen3 and Phi-3 in ``qwen.py``)
as a PyTorch ``nn.Module``.

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
attention functions from ``attention_backend``. ``use_qk_norm`` (Qwen3) adds
a per-head RMSNorm on q and k before rope (``q_norm``, ``k_norm``), which
stays in the model dtype beside 4-bit projections; ``attention_bias``
(Qwen2) gives q, k and v their biases. With toppings attached
(``self.toppings``, the manager's device pools) and a batch that names
adapters, each projection's output gains its tokens' own adapters
(``apply_topping``); a batch that names none skips that path.
``quantization="fp8"`` makes every projection an ``Fp8Linear`` (gate and up
apart, the head left). For the vision models built on it (LLaVA,
Qwen2-VL), ``embed_tokens`` takes the batch's vision features on the rows
of negative placeholder ids, and ``rope_tables`` ropes by Qwen2-VL's 3-D
positions (``mrope_comp``) or by positions shifted by ``rope_delta``.
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
from scratchpad_tpu_torch.ops.quant.fp8 import Fp8Linear, fp8_state, quantize_fp8_stacked
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
    mrope_channel_components,
    mrope_cos_sin,
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
    """``quantization`` w4a8 or w4a16: every projection is a ``QuantLinear``,
    gate and up fused into one ``gate_up`` (gate | up along Out), as the JAX
    package's ``quantize_model_params(fuse_gate_up=True)`` stores them;
    ``fp8``: every projection is an ``Fp8Linear``, gate and up apart, as
    ``quantize_model_params_fp8`` stores them."""

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
        b = cfg.attention_bias
        self.input_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.post_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.fused_gate_up = quantization in ("w4a8", "w4a16")
        if quantization is None:
            lin = lambda n_in, n_out, bias: _linear(n_in, n_out, bias, device, dtype)
        elif quantization == "fp8":
            lin = lambda n_in, n_out, bias: Fp8Linear(n_in, n_out, bias, device, dtype)
        else:
            a8 = quantization == "w4a8"
            lin = lambda n_in, n_out, bias: _quant_linear(n_in, n_out, a8, bias, device, dtype)
        self.wq = lin(H, Hq * D, b)
        self.wk = lin(H, Hkv * D, b)
        self.wv = lin(H, Hkv * D, b)
        self.wo = lin(Hq * D, H, False)
        if cfg.use_qk_norm:
            self.q_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
            self.k_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
        if self.fused_gate_up:
            self.gate_up = lin(H, 2 * I, False)
        else:
            self.gate = lin(H, I, False)
            self.up = lin(H, I, False)
        self.down = lin(I, H, False)


class LlamaForCausalLM(nn.Module):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token.

    ``quantization`` (w4a8, or w4a16 and its aliases) builds the decoder's
    projections as ``QuantLinear``, ``fp8`` as ``Fp8Linear``; ``quantize_lm_head`` adds ``lm_head_q``,
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
        if cfg.multimodal and not getattr(self, "is_multimodal", False):
            raise ValueError(
                f"{type(self).__name__} is a text model; {cfg.architecture} with a vision "
                "config needs its multimodal class"
            )
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        self.embed = skip_init(nn.Embedding, V, H, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            self._make_layer(device, dtype, quantization) for _ in range(cfg.num_hidden_layers)
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
        # multimodal rope (Qwen2-VL): each channel's component, from the
        # config's mrope_section
        section = (cfg.rope_scaling or {}).get("mrope_section")
        self.set_mrope_section(section, device)
        self.sm_scale = float(rope_attention_scale(cfg) / np.sqrt(cfg.head_dim))
        # attention impls (the model-facing functions of ops.attention), set
        # by the runner from attention_backend
        self.decode_attention = None
        self.extend_attention = None
        self.toppings = None  # ToppingsManager.device_pools(), set by the runner

    def _make_layer(self, device, dtype, quantization) -> nn.Module:
        return LlamaDecoderLayer(self.cfg, device, dtype, quantization)

    def set_mrope_section(self, section, device) -> None:
        """Rope by 3-D positions on extend rows that carry them (None: none)."""
        comp = None
        if section:
            comp = torch.as_tensor(
                mrope_channel_components(section, self.cfg.head_dim), dtype=torch.long, device=device
            )
        self.register_buffer("mrope_comp", comp, persistent=False)

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
            if self.cfg.use_qk_norm:
                layer.q_norm.fill_(1.0)
                layer.k_norm.fill_(1.0)
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
        "self_attn.q_norm.weight": "q_norm",
        "self_attn.k_norm.weight": "k_norm",
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
        checkpoint) are kept as they are. Quantization and packing run on
        this model's device."""
        device = self.final_norm.device
        state = dict(state)
        if isinstance(self.layers[0].wq, Fp8Linear):
            return self._quantize_state_fp8(state, device)

        def packed(ql) -> tuple[torch.Tensor, ...]:
            ql = dataclasses.replace(ql, q=ql.q.to(device), s=ql.s.to(device), z=ql.z.to(device))
            return tuple(t[0] for t in pack_w4(ql))

        def in_out(w: torch.Tensor) -> torch.Tensor:
            return w.to(device).T[None]  # [1, in, out]

        if self.layers[0].fused_gate_up and "layers.0.wq.weight" in state:
            for l in range(len(self.layers)):
                dense = {
                    t: in_out(state.pop(f"layers.{l}.{t}.weight"))
                    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down")
                }
                for t, ql in quantize_model_params(dense, fuse_gate_up=True).items():
                    name = "gate_up" if t == "gate_up_f" else t
                    for key, v in zip("qsz", packed(ql)):
                        state[f"layers.{l}.{name}.{key}"] = v
        if self.lm_head_q is not None:
            head = state["embed.weight"] if self.cfg.tie_word_embeddings else state.pop("lm_head.weight")
            for key, v in zip("qsz", packed(quantize_stacked(in_out(head)))):
                state[f"lm_head_q.{key}"] = v
        return state

    def _quantize_state_fp8(self, state: dict, device) -> dict:
        """fp8: each layer's ``[out, in]`` weights transposed to ``[1, in,
        out]`` through ``quantize_fp8_stacked`` on their own device (the JAX
        package's ``quantize_model_params_fp8``, whose codes it gives bit for
        bit; gate and up apart, the head left)."""
        for l in range(len(self.layers)):
            for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
                codes, scales = quantize_fp8_stacked(state.pop(f"layers.{l}.{t}.weight").T[None])
                state.update(fp8_state(codes[0], scales[0], f"layers.{l}.{t}", device))
        return state

    # ---------------------------------------------------------------- forward

    def embed_tokens(self, meta: ForwardMeta) -> torch.Tensor:
        """[T, H]: the embedding of each id, and where a batch carries vision
        features, those features on the rows whose ids are negative
        placeholders (clamped to 0 for the lookup: ``nn.Embedding`` raises
        on a negative id, where JAX's ``take`` clips it)."""
        if meta.input_embeds is None:
            return self.embed(meta.tokens)
        x = self.embed(meta.tokens.clamp_min(0))
        return torch.where((meta.tokens < 0)[:, None], meta.input_embeds.to(x.dtype), x)

    def rope_tables(self, meta: ForwardMeta, inv_freq: torch.Tensor):
        """The forward's cos and sin: by 3-D positions on extend rows of
        image prompts (``mrope_positions``), else by position, shifted by
        each request's ``rope_delta`` where the batch carries one (the three
        components are equal past the prompt, so the shifted 1-D rope is
        exact; JAX ``llama.py:349-363``)."""
        if self.mrope_comp is not None and meta.mrope_positions is not None:
            return mrope_cos_sin(meta.mrope_positions, inv_freq, self.mrope_comp)
        pos = meta.positions
        if meta.rope_delta is not None:
            pos = pos + meta.rope_delta[meta.req_indices]
        return rope_cos_sin(pos, inv_freq)

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
        cos, sin = self.rope_tables(meta, self.inv_freq)
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

        x = self.embed_tokens(meta)  # [T, H]
        for l, layer in enumerate(self.layers):
            h = rms_norm(x, layer.input_norm, eps)
            q = lin(layer, "wq", h, l).view(T, Hq, D)
            k = lin(layer, "wk", h, l).view(T, Hkv, D)
            v = lin(layer, "wv", h, l).view(T, Hkv, D)
            if cfg.use_qk_norm:
                q = rms_norm(q, layer.q_norm, eps)
                k = rms_norm(k, layer.k_norm, eps)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
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
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-normed hidden rows ``h`` [N, H] through the
        LM head (the 4-bit one where the head is quantized), soft-capped
        where the model caps them."""
        if self.lm_head_q is not None:
            logits = self.lm_head_q(h).float()
        else:
            head = self.embed.weight if self.lm_head is None else self.lm_head.weight
            logits = (h @ head.T).float()
        cap = self.cfg.logit_softcap
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits
