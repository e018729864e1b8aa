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
positions (``mrope_comp``) or by positions shifted by ``rope_delta``. Under tensor parallelism (``tp``) a
rank's model holds its heads, MLP columns and vocabulary rows, and sums o's
and down's partial products over the group (``models/common.py::
row_parallel``); with quantized weights each projection holds the rank's
cut of the whole tensor's codes (``parallel.cut_w4``, ``cut_fp8``; the
fused 4-bit gate|up by ``HALVES``), and a row-parallel W4A8 projection
quantizes its slice with the whole row's scale (``QuantLinear``'s ``tp``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.quant.fp8 import Fp8Linear
from scratchpad_tpu_torch.ops.quant.w4a16 import (
    stacked_group_size,
    stacked_out_width,
)
from scratchpad_tpu_torch.models.common import (
    QuantLinear,
    apply_rope,
    fill_random,
    compute_inv_freq,
    mrope_channel_components,
    mrope_cos_sin,
    place_whole,
    quantize_weight,
    rms_norm,
    rope_attention_scale,
    rope_cos_sin,
    row_parallel,
    silu_mul,
    vocab_logits,
    vocab_lookup,
)
from scratchpad_tpu_torch.ops.attention import write_kv
from scratchpad_tpu_torch.parallel import vocab_rows
from scratchpad_tpu_torch.toppings.manager import apply_topping


def _linear(n_in: int, n_out: int, bias: bool, device, dtype) -> nn.Linear:
    # parameters are filled by init_random_ or load_state_dict
    return skip_init(nn.Linear, n_in, n_out, bias=bias, device=device, dtype=dtype)


def _quant_linear(n_in: int, n_out: int, a8: bool, bias: bool, device, dtype, tp=None) -> QuantLinear:
    """The shapes quantize_stacked gives a weight [n_in, n_out]; filled by
    load_state_dict. ``tp``: a row-parallel rank's group, ``n_in`` its share
    of the whole input ``n_in * tp.size``, whose group size it keeps."""
    stored, _ = stacked_out_width(n_out)
    g = stacked_group_size(n_in if tp is None else n_in * tp.size)
    return QuantLinear(n_in, n_out, g, stored, a8, bias, device, dtype, tp)


def projection_maker(quantization, device, dtype):
    """``lin(n_in, n_out, bias, tp=None)``: a projection of ``quantization``
    (None: ``nn.Linear``; fp8: ``Fp8Linear``; else ``QuantLinear``), ``tp``
    the group of a row-parallel one."""
    if quantization is None:
        return lambda n_in, n_out, bias, tp=None: _linear(n_in, n_out, bias, device, dtype)
    if quantization == "fp8":
        return lambda n_in, n_out, bias, tp=None: Fp8Linear(n_in, n_out, bias, device, dtype)
    a8 = quantization == "w4a8"
    return lambda n_in, n_out, bias, tp=None: _quant_linear(n_in, n_out, a8, bias, device, dtype, tp)


class LlamaDecoderLayer(nn.Module):
    """``quantization`` w4a8 or w4a16: every projection is a ``QuantLinear``,
    gate and up fused into one ``gate_up`` (gate | up along Out), as the JAX
    package's ``quantize_model_params(fuse_gate_up=True)`` stores them;
    ``fp8``: every projection is an ``Fp8Linear``, gate and up apart, as
    ``quantize_model_params_fp8`` stores them. ``tp`` (a ``parallel.TPGroup``):
    a tensor-parallel rank's layer, over ``Hq / tp``
    query heads, ``Hkv / tp`` kv heads and ``I / tp`` MLP columns, o and
    down over the rank's share of their inputs (a fused gate_up holds the
    rank's gate columns, then its up columns)."""

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, tp=None):
        super().__init__()
        tp_size = 1 if tp is None else tp.size
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = (n // tp_size for n in (cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size))
        b = cfg.attention_bias
        self.input_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.post_norm = nn.Parameter(torch.empty(H, device=device, dtype=dtype))
        self.fused_gate_up = quantization in ("w4a8", "w4a16")
        lin = projection_maker(quantization, device, dtype)
        self.wq = lin(H, Hq * D, b)
        self.wk = lin(H, Hkv * D, b)
        self.wv = lin(H, Hkv * D, b)
        self.wo = lin(Hq * D, H, False, tp)
        if cfg.use_qk_norm:
            self.q_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
            self.k_norm = nn.Parameter(torch.empty(D, device=device, dtype=dtype))
        if self.fused_gate_up:
            self.gate_up = lin(H, 2 * I, False)
        else:
            self.gate = lin(H, I, False)
            self.up = lin(H, I, False)
        self.down = lin(I, H, False, tp)


def decoder_layers(
    layers: nn.ModuleList,
    cfg: ModelConfig,
    x: torch.Tensor,
    meta: ForwardMeta,
    kv: KVCache,
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend,
    sm_scale: float,
    toppings=None,
    first: int = 0,
    last=None,
    tp=None,
) -> torch.Tensor:
    """Llama decoder ``layers`` ``first`` to ``last - 1`` (all by default)
    over the residual stream ``x`` [T, H], with the rope tables ``cos``,
    ``sin`` and the attention function ``attend``; layer l writes and reads
    the pool's layer l. ``toppings`` adds each token's adapter where the
    batch names any. The target model and the EAGLE head both run it.
    ``tp``: a tensor-parallel rank's group (``parallel.TPGroup``); the
    layers then run on the rank's heads and MLP columns, and the outputs of
    o and down are summed over the group, so that ``x`` stays the same on
    every rank."""
    T = meta.num_tokens
    n = 1 if tp is None else tp.size
    Hq, Hkv, D = cfg.num_attention_heads // n, cfg.num_kv_heads // n, cfg.head_dim
    eps = cfg.rms_norm_eps
    use_toppings = toppings is not None and meta.active_adapters is not None
    if use_toppings:
        token_slot = meta.adapter_slots[meta.req_indices]  # i32[T]

    def topped(y, h, name, l):
        """y + each token's own adapter on projection ``name``."""
        if not use_toppings:
            return y
        return apply_topping(h, y, toppings, name, l, meta.active_adapters, token_slot)

    def lin(layer, name, h, l):
        return topped(getattr(layer, name)(h), h, name, l)

    def row(layer, name, h, l):  # o and down: summed over the group
        return lin(layer, name, h, l) if tp is None else row_parallel(getattr(layer, name), h, tp)

    for l in range(first, len(layers) if last is None else last):
        layer = layers[l]
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
            q, kv, l, meta, sm_scale=sm_scale,
            logit_cap=cfg.attn_logit_softcap, sliding_window=cfg.sliding_window,
        )
        x = x + row(layer, "wo", attn.reshape(T, Hq * D), l)
        h2 = rms_norm(x, layer.post_norm, eps)
        if layer.fused_gate_up:
            # the pools keep gate and up apart: each half gets its own
            gate, up = layer.gate_up(h2).chunk(2, dim=-1)
            gate, up = topped(gate, h2, "gate", l), topped(up, h2, "up", l)
        else:
            gate, up = lin(layer, "gate", h2, l), lin(layer, "up", h2, l)
        x = x + row(layer, "down", silu_mul(gate, up), l)
    return x


class LlamaForCausalLM(nn.Module):
    """``forward(meta, kv) -> f32 logits [B, V]`` at each row's last token.

    ``quantization`` (w4a8, or w4a16 and its aliases) builds the decoder's
    projections as ``QuantLinear``, ``fp8`` as ``Fp8Linear``; ``quantize_lm_head`` adds ``lm_head_q``,
    a 4-bit copy of the head (``embed.T`` when tied; an untied ``lm_head``
    is then dropped), while ``embed`` stays in the model dtype for lookups.
    The quantized state comes from ``quantize_state`` or from the JAX
    package's parameters (``weight_loader.params_from_jax``).

    ``tp`` (a ``parallel.TPGroup``): a tensor-parallel rank's model. The
    layers hold the rank's heads and MLP columns (``decoder_layers``; 4-bit
    or fp8 codes of the whole tensors, cut: ``place_whole``), the embedding
    and an untied head the rank's ``vocab_rows`` rows of the vocabulary
    padded up to a multiple of the group's size; the lookup sums the ranks'
    rows (an id outside a rank's range gives it a zero row), and the head's
    columns are gathered into the whole vocabulary on every rank, the
    padded ones dropped. The head stays in the model dtype (no
    ``quantize_lm_head``), as the JAX runner leaves it on a mesh."""

    # the runner may serve it through attention_backend="pallas"
    supports_pallas_attention = True
    tp_family = "llama"  # its parallel.TP_LAYOUTS table

    def __init__(
        self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None
    ):
        super().__init__()
        if cfg.multimodal and not getattr(self, "is_multimodal", False):
            raise ValueError(
                f"{type(self).__name__} is a text model; {cfg.architecture} with a vision "
                "config needs its multimodal class"
            )
        if tp is not None and quantize_lm_head:
            raise ValueError("a tensor-parallel model keeps its vocabulary-parallel head in the model dtype "
                             "(the JAX runner quantizes the head only without a mesh)")
        self.cfg = cfg
        self.quantization = quantization
        self.tp = tp
        self.tp_size = 1 if tp is None else tp.size
        H = cfg.hidden_size
        V = vocab_rows(cfg.vocab_size, self.tp_size)  # the rank's vocabulary rows
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
        return LlamaDecoderLayer(self.cfg, device, dtype, quantization, tp=self.tp)

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
    def init_random_(self, generator: torch.Generator, place=None) -> None:
        """Random weights (benchmarks, tests without checkpoints), the JAX
        package's scheme: normal / sqrt(fan_in), norms at one, biases zero.
        A tensor-parallel rank draws each single-device tensor in turn, as
        tp 1 does, and keeps its shard (``parallel.shard_tensor``): every
        rank then holds the tp 1 weights, and one whole tensor at most is
        alive at a time. ``place(name, whole)`` takes each draw instead
        (``common.fill_random``)."""
        cfg = self.cfg
        fill = lambda w, name: fill_random(w, name, generator, self.tp, self.tp_family, cfg.vocab_size,
                                           place=place)
        self.reset_constants_()
        fill(self.embed.weight, "embed.weight")
        for l, layer in enumerate(self.layers):
            for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
                fill(getattr(layer, t).weight, f"layers.{l}.{t}.weight")
        if self.lm_head is not None:
            fill(self.lm_head.weight, "lm_head.weight")

    @torch.no_grad()
    def reset_constants_(self) -> None:
        """Norms at one, biases at zero: the random init's constants."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()

    # the decoder weights a quantized model quantizes, by layer
    QUANT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

    # a quantized tensor-parallel rank's load, one whole tensor at a time
    place_whole = place_whole

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
        to ``[in, out]`` so that groups run along In (gate and up joined
        into the 4-bit routes' fused gate|up), through ``quantize_weight``
        on this model's device; the head through it where it is 4-bit.
        Layers that arrive quantized (an imported int4 checkpoint) are kept
        as they are."""
        device = self.final_norm.device
        state = dict(state)
        if self.quantization is not None and "layers.0.wq.weight" in state:
            for l, layer in enumerate(self.layers):
                dense = {t: state.pop(f"layers.{l}.{t}.weight").to(device).T for t in self.QUANT_TARGETS}
                if layer.fused_gate_up:
                    dense["gate_up"] = torch.cat([dense.pop("gate"), dense.pop("up")], dim=1)
                for t, w in dense.items():
                    state.update(quantize_weight(f"layers.{l}.{t}", w, self.quantization)[0])
        if self.lm_head_q is not None:  # 4-bit whatever the layers' route
            head = state["embed.weight"] if self.cfg.tie_word_embeddings else state.pop("lm_head.weight")
            state.update(quantize_weight("lm_head_q", head.to(device).T, "w4a16")[0])
        return state

    # ---------------------------------------------------------------- forward

    def embed_tokens(self, meta: ForwardMeta) -> torch.Tensor:
        """[T, H]: the embedding of each id, and where a batch carries vision
        features, those features on the rows whose ids are negative
        placeholders (clamped to 0 for the lookup: ``nn.Embedding`` raises
        on a negative id, where JAX's ``take`` clips it)."""
        if meta.input_embeds is None:
            return self.lookup(meta.tokens)
        x = self.lookup(meta.tokens.clamp_min(0))
        return torch.where((meta.tokens < 0)[:, None], meta.input_embeds.to(x.dtype), x)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``ids``, vocabulary-parallel under tensor
        parallelism (``common.vocab_lookup``)."""
        return vocab_lookup(self.embed, ids, self.tp)

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
        return self.finish(self.run_layers(self.embed_tokens(meta), meta, kv), meta)

    def run_layers(
        self, x: torch.Tensor, meta: ForwardMeta, kv: KVCache, first: int = 0, last=None
    ) -> torch.Tensor:
        """Decoder layers ``first`` to ``last - 1`` (all by default) over the
        residual stream ``x`` [T, H]; layer l writes and reads the pool's
        layer l. Parameter offload runs them a group at a time."""
        attend = (
            self.decode_attention
            if meta.mode == ForwardMode.DECODE
            else self.extend_attention
        )
        cos, sin = self.rope_tables(meta, self.inv_freq)
        return decoder_layers(
            self.layers, self.cfg, x, meta, kv, cos, sin, attend, self.sm_scale,
            toppings=self.toppings, first=first, last=last, tp=self.tp,
        )

    def finish(self, x: torch.Tensor, meta: ForwardMeta) -> torch.Tensor:
        """The final norm, then every row's hidden state (``capture_all_hidden``),
        the last rows' (``capture_hidden``) or the last rows' logits."""
        h = rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)
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
            logits = vocab_logits(h, head, self.cfg.vocab_size, self.tp)
        cap = self.cfg.logit_softcap
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits
