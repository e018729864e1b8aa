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
neither. Under tensor parallelism (``tp``) a rank holds its heads, its MLP
columns and its vocabulary rows (JAX ``gemma.py:139-161``): the lookup sums
the ranks' rows before the sqrt(hidden) scale, o's and down's partial
products are summed before ``post_attn_norm`` and ``post_ffw_norm``, and
the final soft cap applies to the gathered logits.
``Gemma3ForConditionalGeneration`` adds the SigLIP tower and its pooled,
normed projection; its image rows enter unscaled and attend each
other both ways (``ForwardMeta.mm_spans``, read by the extend kernel).
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
    fill_random,
    gelu_mul,
    rope_cos_sin,
    row_parallel_sum,
    vocab_logits,
    vocab_lookup,
)
from scratchpad_tpu_torch.ops.attention import write_kv
from scratchpad_tpu_torch.parallel import vocab_rows

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

    def __init__(self, cfg: ModelConfig, device, dtype, tp_size: int = 1):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv, I = (n // tp_size for n in (cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size))
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
    tp_family = "gemma"

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False, tp=None):
        super().__init__()
        if quantization is not None or quantize_lm_head:
            raise NotImplementedError(
                f"Gemma options not ported: quantization={quantization!r} (the JAX Gemma "
                "classes read no quantized layers)"
            )
        if cfg.multimodal and not getattr(self, "is_multimodal", False):
            raise ValueError(
                f"{type(self).__name__} is a text model; a vision config needs "
                "Gemma3ForConditionalGeneration"
            )
        self.cfg = cfg
        self.tp = tp
        self.tp_size = 1 if tp is None else tp.size
        H, D = cfg.hidden_size, cfg.head_dim
        V = vocab_rows(cfg.vocab_size, self.tp_size)  # the rank's vocabulary rows
        self.embed = skip_init(nn.Embedding, V, H, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            GemmaDecoderLayer(cfg, device, dtype, self.tp_size) for _ in range(cfg.num_hidden_layers)
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
        norms at zero (a scale of one); a tensor-parallel rank keeps its
        shard of each tp 1 draw (``common.fill_random``)."""
        fill = lambda w, name: fill_random(w, name, generator, self.tp, self.tp_family, self.cfg.vocab_size)
        fill(self.embed.weight, "embed.weight")
        for layer in self.layers:
            for name, p in layer.named_parameters():
                if name.endswith("norm"):
                    p.zero_()
            for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
                fill(getattr(layer, t).weight, f"layers.0.{t}.weight")
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
        Hq, Hkv = cfg.num_attention_heads // self.tp_size, cfg.num_kv_heads // self.tp_size
        D, eps = cfg.head_dim, cfg.rms_norm_eps
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        rope = {
            True: rope_cos_sin(meta.positions, self.inv_freq_local),
            False: rope_cos_sin(meta.positions, self.inv_freq_global),
        }
        mm = meta.input_embeds is not None
        # the ranks' rows summed, then scaled
        x = vocab_lookup(self.embed, meta.tokens.clamp_min(0) if mm else meta.tokens, self.tp)  # [T, H]
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype)
        if mm:  # vision rows (negative placeholder ids) spliced in unscaled, as HF
            x = torch.where((meta.tokens < 0)[:, None], meta.input_embeds.to(x.dtype), x)
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
            # o's and down's partial products summed before their norms
            o = row_parallel_sum(layer.wo(attn.reshape(T, Hq * D)), self.tp)
            x = x + gemma_rms_norm(o, layer.post_attn_norm, eps)
            h2 = gemma_rms_norm(x, layer.pre_ffw_norm, eps)
            mlp = row_parallel_sum(layer.down(gelu_mul(layer.gate(h2), layer.up(h2))), self.tp)
            x = x + gemma_rms_norm(mlp, layer.post_ffw_norm, eps)
        h = gemma_rms_norm(x, self.final_norm, eps)
        if meta.capture_all_hidden:
            return h  # [T, H], for sequence scoring
        last = h[meta.last_token_idx]  # [B, H]
        if meta.capture_hidden:
            return last
        return self.head_logits(last)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-normed rows ``h`` [N, H] through the tied head
        (every column, gathered under tensor parallelism), soft-capped where
        the model caps them."""
        logits = vocab_logits(h, self.embed.weight, self.cfg.vocab_size, self.tp)
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


class Gemma3ForConditionalGeneration(Gemma3ForCausalLM):
    """Gemma 3 multimodal: a SigLIP tower, its patch grid average-pooled to
    ``mm_tokens_per_image`` soft tokens, a (1 + w) RMS norm and a projector
    ``[Hv, H]``, and the Gemma 3 text decoder (JAX ``gemma.py:302-420``). An
    image's rows enter unscaled where text rows are scaled by sqrt(H), and
    attend each other both ways: the engine gives each request its spans,
    which the extend kernel reads from ``ForwardMeta.mm_spans`` (rows 3m and
    3qm), overriding causality and the sliding window."""

    is_multimodal = True
    bidirectional_image_attention = True
    # SigLIP's normalisation (mean and std 0.5) instead of CLIP's
    image_mean = (0.5, 0.5, 0.5)
    image_std = (0.5, 0.5, 0.5)

    def __init__(self, cfg: ModelConfig, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        from scratchpad_tpu_torch.models.vision import SigLIPVisionTower

        device, dtype = self.final_norm.device, self.final_norm.dtype
        mm = cfg.multimodal or {}
        if "vision_config" not in mm:
            raise ValueError("Gemma 3 multimodal needs multimodal.vision_config")
        self.image_token_index = mm.get("image_token_index", 262144)
        self.vision = SigLIPVisionTower(mm["vision_config"], device, dtype)
        self.mm_tokens_per_image = mm.get("mm_tokens_per_image", 256)
        tps = int(round(self.mm_tokens_per_image**0.5))
        ppi = self.vision.grid
        if tps * tps != self.mm_tokens_per_image or ppi % tps:
            raise ValueError(f"{self.mm_tokens_per_image} tokens do not pool a {ppi} x {ppi} grid")
        self.pool_kernel = ppi // tps
        self.tokens_per_side = tps
        Hv, H = self.vision.hidden, cfg.hidden_size
        self.projector = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(Hv, H, device=device, dtype=dtype)),
            "norm": nn.Parameter(torch.empty(Hv, device=device, dtype=dtype)),
        })

    @property
    def num_image_tokens(self) -> int:
        return self.mm_tokens_per_image

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        super().init_random_(generator)
        self.vision.init_random_(generator)
        w = self.projector["w"]
        r = torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
        w.copy_(r / math.sqrt(w.shape[0]))
        self.projector["norm"].zero_()  # the (1 + w) convention

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """HF names in either layout (``model.language_model.*`` or the older
        ``language_model.model.*``); the SigLIP pooling head is unused."""
        lang, vision, proj = {}, {}, {}
        for name, w in state.items():
            if name.startswith("model.language_model."):
                lang["model." + name[len("model.language_model."):]] = w
            elif name.startswith("language_model.model."):
                lang["model." + name[len("language_model.model."):]] = w
            elif ".vision_tower.vision_model." in name or name.startswith("vision_tower.vision_model."):
                sub = name.split("vision_tower.vision_model.", 1)[1]
                if not sub.startswith("head."):
                    vision[sub] = w
            elif "multi_modal_projector." in name:
                proj[name.split("multi_modal_projector.", 1)[1]] = w
            elif name in ("lm_head.weight", "language_model.lm_head.weight"):
                pass  # Gemma ties its head
            else:
                raise KeyError(f"unmapped HF weight {name}")
        out = super().convert_hf_state(lang, dtype)
        out.update(self.vision.convert_hf_state(vision, dtype, prefix="vision."))
        for key, hf in (("w", "mm_input_projection_weight"), ("norm", "mm_soft_emb_norm.weight")):
            t = torch.as_tensor(np.asarray(proj[hf]) if not torch.is_tensor(proj[hf]) else proj[hf])
            out[f"projector.{key}"] = t.to(dtype) if dtype is not None else t  # w is [Hv, H] already
        return out

    def encode_images(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> pooled projected features [N, mm_tokens, H]."""
        feats = self.vision(px)  # [N, P, Hv]
        N, _, Hv = feats.shape
        k, tps = self.pool_kernel, self.tokens_per_side
        pooled = feats.view(N, tps, k, tps, k, Hv).mean(dim=(2, 4)).reshape(N, tps * tps, Hv)
        return gemma_rms_norm(pooled, self.projector["norm"], self.vision.eps) @ self.projector["w"]
