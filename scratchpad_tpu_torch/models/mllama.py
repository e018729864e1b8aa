"""Mllama (Llama 3.2 Vision): a tiled two-stage ViT and a Llama decoder with
cross-attention layers, as PyTorch ``nn.Module``s.

Counterpart of ``scratchpad_tpu/models/mllama.py``:

- **The tower** (``MllamaVisionTower``) takes an image as a stack of
  ``max_num_tiles`` tiles (``multimodal/image.py::preprocess_tiled``, the
  stack zero-padded past its live tiles), its aspect-ratio id and its live
  tile count. A patch embedding, the gated pre-tile embedding of the aspect
  ratio, a class token, the gated position and tile-position embeddings,
  then the patches padded to a multiple of 8 a tile, and every tile
  attending jointly: the bias masks only (pad query, pad key) pairs, a
  padded tile's rows counting as padding, so valid queries do attend the
  zero rows (HF ``_prepare_aspect_ratio_attention_mask``). The local
  layers, the post-tile embedding, the gated global layers; the output is
  the last state beside the local intermediates in HF's interleaved
  (dim, layer) order. Its parameters keep the JAX layout (``[in, out]``
  matrices stacked over the layers), so the JAX pytree maps onto the
  ``state_dict`` by name. Attention is plain torch, as the JAX tower is
  XLA, ``HEAD_BLOCK`` heads at a time.
- **The decoder** runs the Llama decoder's self layers
  (``models/llama.py::decoder_layers``; they write and read the paged pool,
  whose layers are the self layers only, ``num_kv_layers``), each run of
  them followed by one cross layer. A request's image reaches the decoder
  as cross-attention K/V in its slot of ``KVCache.cross`` (``[slots + 1,
  cross layers, S_img, 2 Hkv, D]``, K and V of a head side by side, slot 0
  unused), written once when the request is admitted (``write_cross``:
  ``k_norm`` on K); the prompt keeps one placeholder row
  with the learned ``<|image|>`` embedding. A cross layer
  (``cross_layer``) attends each request's rows against its own slot
  (``cross_attention``, in f32, ``CROSS_SCORE_BYTES`` of scores at a time)
  and adds the tanh-gated output and the tanh-gated MLP; rows of requests
  without an image keep their residual unchanged.
- **Where HF and the JAX package part**, the port follows HF
  (``ROADMAP.md`` Queue 3, found in the reference): the padding tiles are
  masked on decode rows as on extend rows (the JAX decode windows drop
  ``cross_lens``), and rows before the ``<|image|>`` placeholder
  (``ForwardMeta.cross_requests[i].text_rows``) attend every cross row
  unmasked and get no cross MLP, as HF's processor mask and
  ``full_text_row_masked_out_mask`` make them (the JAX package treats them
  as image rows).

Refused: quantization, 8-bit KV (the runner), toppings and speculative
decoding (the scheduler).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.common import rms_norm, silu_mul
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM, decoder_layers
from scratchpad_tpu_torch.models.vision import attention_workspace_bytes, layer_norm, layer_stack

_NEG = -1e30
HEAD_BLOCK = 4  # the tower's heads scored at a time
CROSS_SCORE_BYTES = 1 << 30  # a cross layer's f32 scores and probabilities at a time


def _gated(lp: nn.ParameterDict, name: str) -> Optional[torch.Tensor]:
    return torch.tanh(lp[name]) if name in lp else None


class MllamaVisionTower(nn.Module):
    """HF ``MllamaVisionModel`` over static stacks of ``max_num_tiles`` tiles."""

    # images a forward encodes: one a request
    encode_batch = 1

    def __init__(self, vcfg: dict, device, dtype):
        super().__init__()
        self.hv = vcfg["hidden_size"]
        self.heads = vcfg.get("attention_heads", 16)
        self.num_layers = vcfg["num_hidden_layers"]
        self.global_layers = vcfg.get("num_global_layers", 8)
        self.image_size = vcfg["image_size"]
        self.patch = vcfg["patch_size"]
        self.channels = vcfg.get("num_channels", 3)
        self.inter = vcfg.get("intermediate_size", 4 * self.hv)
        self.max_tiles = vcfg.get("max_num_tiles", 4)
        self.inter_idx = list(vcfg.get("intermediate_layers_indices", [self.num_layers - 1]))
        self.supported_aspect_ratios = [tuple(a) for a in vcfg.get("supported_aspect_ratios") or [[1, 1]]]
        self.grid = self.image_size // self.patch
        self.num_patches = self.grid * self.grid + 1
        self.out_dim = self.hv * (1 + len(self.inter_idx))
        Hv, P0, T, AR = self.hv, self.num_patches, self.max_tiles, len(self.supported_aspect_ratios)
        kw = dict(device=device, dtype=dtype)

        def vec(*shape):
            return nn.Parameter(torch.empty(*shape, **kw))

        self.patch_w = vec(self.channels * self.patch**2, Hv)
        self.class_emb = vec(Hv)
        self.pos_gate = vec(1)
        self.pos_emb = vec(P0, Hv)
        self.tile_pos_emb = vec(AR + 1, T * P0 * Hv)
        self.pre_tile_emb = vec(AR + 1, T * Hv)
        self.pre_tile_gate = vec(1)
        self.post_tile_emb = vec(AR + 1, T * Hv)
        self.post_tile_gate = vec(1)
        self.ln_pre_w, self.ln_pre_b = vec(Hv), vec(Hv)
        self.ln_post_w, self.ln_post_b = vec(Hv), vec(Hv)
        self.local = self._encoder(self.num_layers, kw)
        # "global" is a keyword: the JAX pytree's name, reached as self.glob
        self.add_module("global", self._encoder(self.global_layers, kw, gated=True))

    @property
    def glob(self) -> nn.ParameterDict:
        return self._modules["global"]

    def _encoder(self, L: int, kw: dict, gated: bool = False) -> nn.ParameterDict:
        Hv, I = self.hv, self.inter
        p = {
            "ln1_w": layer_stack(L, Hv, **kw), "ln1_b": layer_stack(L, Hv, **kw),
            "ln2_w": layer_stack(L, Hv, **kw), "ln2_b": layer_stack(L, Hv, **kw),
            "wq": layer_stack(L, Hv, Hv, **kw), "wk": layer_stack(L, Hv, Hv, **kw),
            "wv": layer_stack(L, Hv, Hv, **kw), "wo": layer_stack(L, Hv, Hv, **kw),
            "fc1": layer_stack(L, Hv, I, **kw), "fc1_b": layer_stack(L, I, **kw),
            "fc2": layer_stack(L, I, Hv, **kw), "fc2_b": layer_stack(L, Hv, **kw),
        }
        if gated:
            p["gate_attn"] = layer_stack(L, 1, **kw)
            p["gate_ffn"] = layer_stack(L, 1, **kw)
        return nn.ParameterDict(p)

    @property
    def padded_patches(self) -> int:
        return -(-self.num_patches // 8) * 8

    def workspace_bytes(self, images: int) -> int:
        """Peak bytes beside the weights for ``images`` images at once: one
        head block's attention, the f32 bias over every row pair and the
        MLP's hidden rows."""
        L = self.max_tiles * self.padded_patches
        itemsize = self.patch_w.element_size()
        attn = attention_workspace_bytes(images, min(HEAD_BLOCK, self.heads), L, itemsize)
        return attn + images * L * L * 4 + images * L * self.inter * 4

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX package's scheme: matrices and embeddings normal /
        sqrt(fan_in) (the embeddings' fan-in Hv), norms at one, biases and
        the gates at zero (as HF's init: tanh(0) shuts them)."""
        for name, p in self.named_parameters():
            last = name.split(".")[-1]
            if last in ("ln1_w", "ln2_w", "ln_pre_w", "ln_post_w"):
                p.fill_(1.0)
            elif last.endswith("_b") or "gate" in last:
                p.zero_()
            else:
                fan_in = self.hv if "emb" in last or p.dim() < 2 else p.shape[-2]
                r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(r / math.sqrt(fan_in))

    HF_LAYER_MAP = {
        "input_layernorm.weight": ("ln1_w", False), "input_layernorm.bias": ("ln1_b", False),
        "post_attention_layernorm.weight": ("ln2_w", False),
        "post_attention_layernorm.bias": ("ln2_b", False),
        "self_attn.q_proj.weight": ("wq", True), "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True), "self_attn.o_proj.weight": ("wo", True),
        "mlp.fc1.weight": ("fc1", True), "mlp.fc1.bias": ("fc1_b", False),
        "mlp.fc2.weight": ("fc2", True), "mlp.fc2.bias": ("fc2_b", False),
        "gate_attn": ("gate_attn", False), "gate_ffn": ("gate_ffn", False),
    }
    HF_TOP = {
        "class_embedding": "class_emb",
        "gated_positional_embedding.gate": "pos_gate",
        "gated_positional_embedding.embedding": "pos_emb",
        "gated_positional_embedding.tile_embedding.weight": "tile_pos_emb",
        "pre_tile_positional_embedding.gate": "pre_tile_gate",
        "pre_tile_positional_embedding.embedding.weight": "pre_tile_emb",
        "post_tile_positional_embedding.gate": "post_tile_gate",
        "post_tile_positional_embedding.embedding.weight": "post_tile_emb",
        "layernorm_pre.weight": "ln_pre_w", "layernorm_pre.bias": "ln_pre_b",
        "layernorm_post.weight": "ln_post_w", "layernorm_post.bias": "ln_post_b",
    }

    def convert_hf_state(self, state: dict, dtype=None, prefix: str = "") -> dict[str, torch.Tensor]:
        """HF ``vision_model.*`` tensors (that prefix stripped) as this
        tower's ``state_dict`` entries under ``prefix`` (JAX
        ``MllamaVisionTower.convert_hf_state``): linear weights transposed to
        ``[in, out]`` and stacked over the layers, the patch conv flattened
        to ``[C * p * p, Hv]``."""
        out: dict[str, torch.Tensor] = {}
        stacks = {"local": {}, "global": {}}
        count = {"local": self.num_layers, "global": self.global_layers}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if name == "patch_embedding.weight":
                out["patch_w"] = t.reshape(t.shape[0], -1).T
            elif name in self.HF_TOP:
                out[self.HF_TOP[name]] = t
            elif name.startswith(("transformer.layers.", "global_transformer.layers.")):
                which = "local" if name.startswith("transformer.") else "global"
                l, sub = name.split(".layers.", 1)[1].split(".", 1)
                if sub not in self.HF_LAYER_MAP:
                    raise KeyError(f"unmapped mllama vision weight {name}")
                key, transpose = self.HF_LAYER_MAP[sub]
                stacks[which].setdefault(key, [None] * count[which])[int(l)] = t.T if transpose else t
            else:
                raise KeyError(f"unmapped mllama vision weight {name}")
        for which, per_key in stacks.items():
            for key, ws in per_key.items():
                if any(w is None for w in ws):
                    raise KeyError(f"mllama vision {which}.{key}: missing layers")
                out[f"{which}.{key}"] = torch.stack([w.reshape(1) if w.dim() == 0 else w for w in ws])
        return {
            prefix + k: (v.to(dtype) if dtype is not None else v).contiguous() for k, v in out.items()
        }

    def _attention(self, q, k, v, bias: torch.Tensor) -> torch.Tensor:
        """Every row against every row of its image, ``HEAD_BLOCK`` heads at
        a time: f32 scores plus ``bias`` [N, L, L], f32 softmax, the
        probabilities in the activations' dtype (the JAX ``enc_layer``)."""
        N, L, heads, hd = q.shape
        out = torch.empty_like(q)
        for h0 in range(0, heads, HEAD_BLOCK):
            h1 = min(h0 + HEAD_BLOCK, heads)
            s = torch.einsum("nqhd,nkhd->nhqk", q[:, :, h0:h1], k[:, :, h0:h1]).float() * hd**-0.5
            a = torch.softmax(s + bias[:, None], dim=-1).to(q.dtype)
            out[:, :, h0:h1] = torch.einsum("nhqk,nkhd->nqhd", a, v[:, :, h0:h1])
        return out.reshape(N, L, heads * hd)

    def _layer(self, x, lp: nn.ParameterDict, l: int, bias) -> torch.Tensor:
        N, L, Hv = x.shape
        heads = self.heads
        y = layer_norm(x, lp["ln1_w"][l], lp["ln1_b"][l], 1e-5)
        q, k, v = ((y @ lp[w][l]).view(N, L, heads, Hv // heads) for w in ("wq", "wk", "wv"))
        o = self._attention(q, k, v, bias) @ lp["wo"][l]
        gate = _gated(lp, "gate_attn")
        x = x + (o if gate is None else o * gate[l])
        y = layer_norm(x, lp["ln2_w"][l], lp["ln2_b"][l], 1e-5)
        m = F.gelu(y @ lp["fc1"][l] + lp["fc1_b"][l]) @ lp["fc2"][l] + lp["fc2_b"][l]
        gate = _gated(lp, "gate_ffn")
        return x + (m if gate is None else m * gate[l])

    def forward(self, px: torch.Tensor, ar_ids: torch.Tensor, n_tiles: torch.Tensor) -> torch.Tensor:
        """Tiles [N, T, C, S, S], aspect-ratio ids [N] (1-based into the
        config's ``supported_aspect_ratios``) and live tile counts [N] ->
        features [N, T * num_patches, out_dim]."""
        N, T = px.shape[:2]
        Hv, p, g, C, Tm, P0 = self.hv, self.patch, self.grid, self.channels, self.max_tiles, self.num_patches
        x = px.reshape(N, T, C, g, p, g, p).permute(0, 1, 3, 5, 2, 4, 6)
        x = x.reshape(N, T, g * g, C * p * p).to(self.patch_w.dtype) @ self.patch_w
        pre = self.pre_tile_emb[ar_ids].view(N, Tm, 1, Hv)[:, :T]
        x = x + pre * torch.tanh(self.pre_tile_gate)
        x = torch.cat([self.class_emb.expand(N, T, 1, Hv), x], dim=2)  # [N, T, P0, Hv]
        gate = torch.tanh(self.pos_gate)
        x = x + (1 - gate) * self.pos_emb
        x = x + gate * self.tile_pos_emb[ar_ids].view(N, Tm, P0, Hv)[:, :T]
        x = layer_norm(x, self.ln_pre_w, self.ln_pre_b, 1e-5)
        Pp = self.padded_patches
        L = T * Pp
        x = F.pad(x, (0, 0, 0, Pp - P0)).reshape(N, L, Hv)
        pad = torch.arange(Pp, device=x.device) >= P0
        pad = (torch.arange(T, device=x.device)[None, :, None] >= n_tiles[:, None, None]) | pad[None, None]
        inv = pad.reshape(N, L).float()
        bias = inv[:, :, None] * inv[:, None, :] * _NEG
        inters = []
        for l in range(self.num_layers):
            x = self._layer(x, self.local, l, bias)
            if l in self.inter_idx:
                inters.append(x)
        x = layer_norm(x, self.ln_post_w, self.ln_post_b, 1e-5)
        post = self.post_tile_emb[ar_ids].view(N, Tm, 1, Hv)[:, :T]
        x = (x.view(N, T, Pp, Hv) + post * torch.tanh(self.post_tile_gate)).view(N, L, Hv)
        for l in range(self.global_layers):
            x = self._layer(x, self.glob, l, bias)

        def unpad(h):
            return h.view(N, T, Pp, -1)[:, :, :P0].reshape(N, T * P0, -1)

        # HF stacks the intermediates on a last axis, then flattens: the
        # features interleave (dim, layer)
        inter = torch.stack([unpad(h) for h in inters], dim=-1).reshape(N, T * P0, -1)
        return torch.cat([unpad(x), inter], dim=-1)


class MllamaForCausalLM(LlamaForCausalLM):
    """The Llama decoder with cross-attention layers; ``forward(meta, kv) ->
    f32 logits [B, V]`` as the Llama model's. ``num_hidden_layers`` counts
    both kinds (HF's convention); ``layers`` holds the self layers and the
    pool only theirs (``num_kv_layers``); cross layers past a config cut in
    depth are left out. The embedding has HF's 8 extra rows (``<|image|>``
    among them); the head keeps ``vocab_size``."""

    is_multimodal = True
    has_cross_attention = True
    supports_toppings = False

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False):
        if quantization is not None or quantize_lm_head:
            raise NotImplementedError(
                f"MllamaForConditionalGeneration options not ported: quantization={quantization!r} "
                "(no parity test against the JAX engine yet; ROADMAP.md)"
            )
        total = cfg.num_hidden_layers
        self.cross_idx = sorted(i for i in cfg.cross_attention_layers or [] if i < total)
        if not self.cross_idx:
            raise ValueError("Mllama needs cross_attention_layers within its num_hidden_layers")
        mm = cfg.multimodal or {}
        if "vision_config" not in mm:
            raise ValueError("Mllama needs multimodal.vision_config")
        self.num_kv_layers = total - len(self.cross_idx)
        # runs of self layers, each followed by one cross layer (or none)
        self.segments: list[tuple[int, Optional[int]]] = []
        run = 0
        for i in range(total):
            if i in self.cross_idx:
                self.segments.append((run, self.cross_idx.index(i)))
                run = 0
            else:
                run += 1
        if run:
            self.segments.append((run, None))
        super().__init__(dataclasses.replace(cfg, num_hidden_layers=self.num_kv_layers), device, dtype)
        H, V, D = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
        Hq, Hkv, I, Lx = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size, len(self.cross_idx)
        self.embed = skip_init(nn.Embedding, V + 8, H, device=device, dtype=dtype)
        self.image_token_index = mm.get("image_token_index", 128256)
        self.num_image_tokens = 1  # one placeholder row an image
        kw = dict(device=device, dtype=dtype)
        self.cross_layers = nn.ParameterDict({
            "input_norm": layer_stack(Lx, H, **kw), "post_norm": layer_stack(Lx, H, **kw),
            "q_norm": layer_stack(Lx, D, **kw), "k_norm": layer_stack(Lx, D, **kw),
            "wq": layer_stack(Lx, H, Hq * D, **kw), "wk": layer_stack(Lx, H, Hkv * D, **kw),
            "wv": layer_stack(Lx, H, Hkv * D, **kw), "wo": layer_stack(Lx, Hq * D, H, **kw),
            "gate": layer_stack(Lx, H, I, **kw), "up": layer_stack(Lx, H, I, **kw),
            "down": layer_stack(Lx, I, H, **kw),
            "gate_attn": layer_stack(Lx, 1, **kw), "gate_ffn": layer_stack(Lx, 1, **kw),
        })
        self.vision = MllamaVisionTower(mm["vision_config"], device, dtype)
        self.projector = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(self.vision.out_dim, H, **kw)),
            "b": nn.Parameter(torch.empty(H, **kw)),
        })

    @property
    def cross_len(self) -> int:
        """Cross rows a slot holds: every tile's patches."""
        return self.vision.max_tiles * self.vision.num_patches

    # ------------------------------------------------------------- parameters

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX package's scheme (``MllamaForCausalLM.init_params``): the
        cross layers' matrices normal / sqrt(fan_in), their norms at one,
        their gates at zero (HF's init: an image moves nothing until they
        are set); the projector's bias at zero."""
        super().init_random_(generator)

        def fill(p, fan_in):
            r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            p.copy_(r / math.sqrt(fan_in))

        for name, p in self.cross_layers.items():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.startswith("gate_"):
                p.zero_()
            else:
                fill(p, p.shape[-2])
        self.vision.init_random_(generator)
        fill(self.projector["w"], self.vision.out_dim)
        self.projector["b"].zero_()

    CROSS_MAP = {
        "cross_attn.q_proj.weight": ("wq", True), "cross_attn.k_proj.weight": ("wk", True),
        "cross_attn.v_proj.weight": ("wv", True), "cross_attn.o_proj.weight": ("wo", True),
        "cross_attn.q_norm.weight": ("q_norm", False), "cross_attn.k_norm.weight": ("k_norm", False),
        "cross_attn_attn_gate": ("gate_attn", False), "cross_attn_mlp_gate": ("gate_ffn", False),
        "mlp.gate_proj.weight": ("gate", True), "mlp.up_proj.weight": ("up", True),
        "mlp.down_proj.weight": ("down", True),
        "input_layernorm.weight": ("input_norm", False),
        "post_attention_layernorm.weight": ("post_norm", False),
    }

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """HF ``MllamaForConditionalGeneration`` names, both nestings
        (``model.language_model.*`` since transformers 4.52,
        ``language_model.model.*`` before), as the JAX ``convert_hf_state``
        splits them: the self layers renumbered 0 to ``num_kv_layers - 1``,
        the cross layers stacked ``[in, out]``, the tower and the projector
        (``[out_dim, H]``)."""
        lang, vision, stacks = {}, {}, {}
        self_ids = [i for i in range(self.num_kv_layers + len(self.cross_idx)) if i not in self.cross_idx]
        remap = {old: new for new, old in enumerate(self_ids)}
        out: dict[str, torch.Tensor] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            n = name[len("model."):] if name.startswith("model.") else name
            if n.startswith("vision_model."):
                vision[n[len("vision_model."):]] = t
                continue
            if n.startswith("multi_modal_projector."):
                out["projector." + ("w" if n.endswith("weight") else "b")] = t.T if n.endswith("weight") else t
                continue
            if n.startswith("language_model.model."):
                n = n[len("language_model."):]
            elif n.startswith("language_model."):
                rest = n[len("language_model."):]
                n = rest if rest == "lm_head.weight" else "model." + rest
            elif n != "lm_head.weight":
                raise KeyError(f"unmapped HF weight {name}")
            if n.startswith("model.layers."):
                idx, sub = n[len("model.layers."):].split(".", 1)
                idx = int(idx)
                if idx in self.cross_idx:
                    key, transpose = self.CROSS_MAP[sub]
                    stacks.setdefault(key, [None] * len(self.cross_idx))[self.cross_idx.index(idx)] = (
                        t.T if transpose else t.reshape(-1) if t.dim() == 0 else t
                    )
                elif idx in remap:
                    lang[f"model.layers.{remap[idx]}.{sub}"] = t
            else:
                lang[n] = t
        out.update(super().convert_hf_state(lang, dtype))
        for key, ws in stacks.items():
            if any(w is None for w in ws):
                raise KeyError(f"cross_layers.{key}: missing layers")
            out[f"cross_layers.{key}"] = torch.stack(ws)
        out.update(self.vision.convert_hf_state(vision, None, prefix="vision."))
        return {k: (v.to(dtype) if dtype is not None else v).contiguous() for k, v in out.items()}

    # ---------------------------------------------------------------- vision

    def encode_images(self, px: torch.Tensor, ar_ids: torch.Tensor, n_tiles: torch.Tensor) -> torch.Tensor:
        """Tiles [N, T, C, S, S] -> projected cross states [N, T *
        num_patches, H]."""
        pr = self.projector
        return self.vision(px, ar_ids, n_tiles) @ pr["w"] + pr["b"]

    # --------------------------------------------------------------- forward

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        x = self.embed_tokens(meta)
        attend = self.decode_attention if meta.mode == ForwardMode.DECODE else self.extend_attention
        cos, sin = self.rope_tables(meta, self.inv_freq)
        masks = self._cross_masks(meta, x) if meta.cross_requests else None
        start = 0
        for n_self, ci in self.segments:
            if n_self:
                x = decoder_layers(self.layers, self.cfg, x, meta, kv, cos, sin, attend, self.sm_scale,
                                   first=start, last=start + n_self)
                start += n_self
            if ci is not None and masks is not None:
                x = self.cross_layer(ci, x, meta, kv, masks)
        return self.finish(x, meta)

    def write_cross(self, kv: KVCache, slot: int, states: torch.Tensor) -> None:
        """Project one image's vision states [S, H] into each cross layer's
        K (``k_norm`` on it) and V, written side by side a head into slot
        ``slot``, its rows past S zeroed (JAX ``_write_cross``, which writes
        the states zero-padded to the slot)."""
        cfg, cp = self.cfg, self.cross_layers
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        cs = states.to(kv.cross.dtype)
        S = cs.shape[0]
        kv.cross[slot, :, S:] = 0
        for ci in range(len(self.cross_idx)):
            k = rms_norm((cs @ cp["wk"][ci]).view(S, Hkv, D), cp["k_norm"][ci], cfg.rms_norm_eps)
            v = (cs @ cp["wv"][ci]).view(S, Hkv, D)
            kv.cross[slot, ci, :S] = torch.stack([k, v], dim=2).view(S, 2 * Hkv, D)

    def _cross_masks(self, meta: ForwardMeta, x: torch.Tensor):
        """[T, 1] row masks in ``x``'s dtype, filled on its device once a
        forward: 1 on the rows of requests with an image (the attention
        output), and on those of them at or after the image placeholder
        (the MLP)."""
        attn, mlp = x.new_zeros(x.shape[0], 1), x.new_zeros(x.shape[0], 1)
        for r in meta.cross_requests:
            attn[r.first : r.end] = 1
            mlp[r.first + r.text_rows : r.end] = 1
        return attn, mlp

    def cross_layer(self, ci: int, x: torch.Tensor, meta: ForwardMeta, kv: KVCache, masks) -> torch.Tensor:
        """Cross layer ``ci`` over the residual stream ``x`` [T, H]. The
        projections run over every row, as the self layers' do, so that a
        row's numbers do not depend on its batch; attention runs for the
        requests with an image alone, each against its own slot, and the
        masks keep every other row's residual as it was (JAX
        ``_cross_layer``: x + tanh(gate) * out * mask)."""
        cfg, cp = self.cfg, self.cross_layers
        T, eps = x.shape[0], cfg.rms_norm_eps
        Hq, D = cfg.num_attention_heads, cfg.head_dim
        q = rms_norm((rms_norm(x, cp["input_norm"][ci], eps) @ cp["wq"][ci]).view(T, Hq, D), cp["q_norm"][ci], eps)
        out = x.new_zeros(T, Hq * D)
        for r in meta.cross_requests:
            out[r.first : r.end] = cross_attention(
                q[r.first : r.end], kv.cross[r.slot, ci], r.live, r.text_rows, D**-0.5
            ).to(x.dtype)
        attn_mask, mlp_mask = masks
        x = x + torch.tanh(cp["gate_attn"][ci]) * (out @ cp["wo"][ci]) * attn_mask
        h = rms_norm(x, cp["post_norm"][ci], eps)
        m = silu_mul(h @ cp["gate"][ci], h @ cp["up"][ci]) @ cp["down"][ci]
        return x + torch.tanh(cp["gate_ffn"][ci]) * m * mlp_mask


def cross_attention(q: torch.Tensor, kv_slot: torch.Tensor, live: int, text_rows: int, scale: float) -> torch.Tensor:
    """One request's rows ``q`` [n, Hq, D] against its slot ``kv_slot`` [S,
    2 Hkv, D] (K and V of head h at rows 2h and 2h + 1), in f32: rows from
    ``text_rows`` on attend the first ``live`` cross rows (its live tiles),
    the rows before them every cross row (HF's processor leaves their
    cross mask empty, and an empty row is unmasked). Queries go in blocks
    whose scores and probabilities stay under ``CROSS_SCORE_BYTES``.
    Returns f32 [n, Hq * D]."""
    n, Hq, D = q.shape
    S, Hkv = kv_slot.shape[0], kv_slot.shape[1] // 2
    k, v = kv_slot[:, 0::2].float(), kv_slot[:, 1::2].float()  # [S, Hkv, D]
    qf = q.float().view(n, Hkv, Hq // Hkv, D)
    pos = torch.arange(S, device=q.device)
    step = max(1, CROSS_SCORE_BYTES // (Hq * S * 8))
    out = []
    for t0 in range(0, n, step):
        t1 = min(t0 + step, n)
        s = torch.einsum("thgd,shd->thgs", qf[t0:t1], k) * scale
        if t1 > text_rows:
            image_rows = (torch.arange(t0, t1, device=q.device) >= text_rows)[:, None, None, None]
            s = torch.where(image_rows & (pos >= live), _NEG, s)
        a = torch.softmax(s, dim=-1)
        out.append(torch.einsum("thgs,shd->thgd", a, v).reshape(t1 - t0, Hq * D))
    return out[0] if len(out) == 1 else torch.cat(out)


def cross_workspace_bytes(cfg: ModelConfig, cross_len: int) -> int:
    """What a cross layer holds beside the pool at once: one block of f32
    scores and probabilities and one slot's K and V in f32."""
    return CROSS_SCORE_BYTES + 2 * cross_len * cfg.num_kv_heads * cfg.head_dim * 4
