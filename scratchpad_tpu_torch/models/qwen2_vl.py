"""Qwen2-VL: a ViT with 2-D rope and a patch merger, on the Qwen2 decoder
with multimodal rope.

Counterpart of ``scratchpad_tpu/models/qwen2_vl.py``. As there, every image
is one fixed square (``multimodal.image_size``, 448 by default: a 32 x 32
patch grid merged to 256 tokens), and a video is a run of such frames,
``temporal_patch_size`` real frames a temporal patch (an odd tail repeats
the last frame). The tower keeps the JAX layout (``patch_w [C tp p p, E]``,
``blocks.qkv_w [L, E, 3E]``, ..., ``merger.w1``), stacked over its blocks.

The decoder is the Llama decoder with q, k, v biases; its rope takes the
``[3, T]`` table of ``compute_mrope`` on the extend rows of image and video
prompts (``ForwardMeta.mrope_positions``) and, on every later row, the
plain position shifted by the request's ``rope_delta``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.models.vision import (
    attention_workspace_bytes,
    layer_norm,
    layer_stack,
    quick_gelu,
    vision_attention,
)


class Qwen2VisionTower(nn.Module):
    """HF ``Qwen2VisionTransformer`` at one fixed square resolution."""

    def __init__(self, vcfg: dict, image_size: int, device, dtype):
        super().__init__()
        self.embed = vcfg["embed_dim"]
        self.depth = vcfg["depth"]
        self.heads = vcfg["num_heads"]
        self.mlp_ratio = vcfg.get("mlp_ratio", 4)
        self.channels = vcfg.get("in_channels", 3)
        self.patch = vcfg.get("patch_size", 14)
        self.merge = vcfg.get("spatial_merge_size", 2)
        self.tpatch = vcfg.get("temporal_patch_size", 2)
        self.out_dim = vcfg["hidden_size"]
        self.image_size = image_size
        self.grid = image_size // self.patch
        if self.grid * self.patch != image_size or self.grid % self.merge:
            raise ValueError(f"image_size {image_size}: patch {self.patch}, merge {self.merge}")
        self.head_dim = self.embed // self.heads
        E, L = self.embed, self.depth
        I = E * self.mlp_ratio
        D = self.channels * self.tpatch * self.patch * self.patch
        M = E * self.merge * self.merge
        kw = dict(device=device, dtype=dtype)
        self.patch_w = nn.Parameter(torch.empty(D, E, **kw))
        self.blocks = nn.ParameterDict({
            "ln1_w": layer_stack(L, E, **kw), "ln1_b": layer_stack(L, E, **kw),
            "ln2_w": layer_stack(L, E, **kw), "ln2_b": layer_stack(L, E, **kw),
            "qkv_w": layer_stack(L, E, 3 * E, **kw), "qkv_b": layer_stack(L, 3 * E, **kw),
            "proj_w": layer_stack(L, E, E, **kw), "proj_b": layer_stack(L, E, **kw),
            "fc1": layer_stack(L, E, I, **kw), "fc1_b": layer_stack(L, I, **kw),
            "fc2": layer_stack(L, I, E, **kw), "fc2_b": layer_stack(L, E, **kw),
        })
        self.merger = nn.ParameterDict({
            "ln_w": nn.Parameter(torch.empty(E, **kw)), "ln_b": nn.Parameter(torch.empty(E, **kw)),
            "w1": nn.Parameter(torch.empty(M, M, **kw)), "b1": nn.Parameter(torch.empty(M, **kw)),
            "w2": nn.Parameter(torch.empty(M, self.out_dim, **kw)),
            "b2": nn.Parameter(torch.empty(self.out_dim, **kw)),
        })
        cos, sin = self._rot_tables()
        self.register_buffer("rot_cos", cos.to(device), persistent=False)
        self.register_buffer("rot_sin", sin.to(device), persistent=False)

    @property
    def num_tokens(self) -> int:
        return (self.grid // self.merge) ** 2

    @property
    def llm_grid(self) -> int:
        return self.grid // self.merge

    def _rot_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each patch's 2-D rope angles in merge-block order (the JAX
        ``_rot_emb``), as f32 cos and sin [L, 1, head_dim]."""
        g, m = self.grid, self.merge
        hpos = np.arange(g)[:, None] + np.zeros((1, g), np.int64)
        wpos = np.arange(g)[None, :] + np.zeros((g, 1), np.int64)

        def block_order(ids):
            return ids.reshape(g // m, m, g // m, m).transpose(0, 2, 1, 3).reshape(-1)

        hpos, wpos = block_order(hpos), block_order(wpos)
        dim = self.head_dim // 2
        inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = np.concatenate([np.outer(hpos, inv), np.outer(wpos, inv)], axis=-1).astype(np.float32)
        emb = torch.from_numpy(np.concatenate([ang, ang], axis=-1))[:, None, :]
        return torch.cos(emb), torch.sin(emb)

    def patchify(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] (a still image, repeated over the temporal patch) or
        [N, tp, C, S, S] (a temporal patch of real frames) -> [N, g * g, C tp
        p p] in the merge blocks' order (hb, wb, ih, iw), each patch
        flattened as (C, tp, ph, pw), as HF's ``Qwen2VLImageProcessor``."""
        N = px.shape[0]
        C, p, g, m, tp = self.channels, self.patch, self.grid, self.merge, self.tpatch
        if px.dim() == 5:
            x = px.reshape(N, tp, C, g, p, g, p).permute(0, 3, 5, 2, 1, 4, 6)
            x = x.reshape(N, g, g, C, tp, p * p)
        else:
            x = px.reshape(N, C, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
            x = x.reshape(N, g, g, C, 1, p * p).expand(N, g, g, C, tp, p * p)
        D = C * tp * p * p
        x = x.reshape(N, g // m, m, g // m, m, D).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(N, g * g, D).to(self.patch_w.dtype)

    def _rope(self, v: torch.Tensor) -> torch.Tensor:  # [N, L, heads, hd]
        vf = v.float()
        v1, v2 = vf.chunk(2, dim=-1)
        return (vf * self.rot_cos + torch.cat([-v2, v1], dim=-1) * self.rot_sin).to(v.dtype)

    def forward(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] or [N, tp, C, S, S] -> merged features [N, tokens,
        out_dim]."""
        E, Hn, hd = self.embed, self.heads, self.head_dim
        x = self.patchify(px) @ self.patch_w  # [N, L, E]
        N, Lp, _ = x.shape
        bp = self.blocks
        for l in range(self.depth):
            y = layer_norm(x, bp["ln1_w"][l], bp["ln1_b"][l], 1e-6)
            qkv = (y @ bp["qkv_w"][l] + bp["qkv_b"][l]).view(N, Lp, 3, Hn, hd)
            q, k = self._rope(qkv[:, :, 0]), self._rope(qkv[:, :, 1])
            x = x + (vision_attention(q, k, qkv[:, :, 2], hd**-0.5) @ bp["proj_w"][l] + bp["proj_b"][l])
            y = layer_norm(x, bp["ln2_w"][l], bp["ln2_b"][l], 1e-6)
            x = x + (quick_gelu(y @ bp["fc1"][l] + bp["fc1_b"][l]) @ bp["fc2"][l] + bp["fc2_b"][l])
        mp = self.merger
        x = layer_norm(x, mp["ln_w"], mp["ln_b"], 1e-6)
        M = E * self.merge * self.merge
        x = x.reshape(N, Lp * E // M, M)  # consecutive m * m patches: one block
        x = F.gelu(x @ mp["w1"] + mp["b1"])
        return x @ mp["w2"] + mp["b2"]

    def workspace_bytes(self, images: int) -> int:
        """Peak bytes beside the weights for ``images`` images (or temporal
        patches) at once: the attention's scores and the MLP's hidden rows."""
        P = self.grid**2
        mlp = images * P * self.embed * self.mlp_ratio * 4
        return attention_workspace_bytes(images, self.heads, P, self.patch_w.element_size()) + mlp

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX scheme: matrices normal / sqrt(fan_in), norms at one,
        biases at zero."""
        for name, p in self.named_parameters():
            leaf = name.split(".")[-1]
            if leaf in ("ln1_w", "ln2_w", "ln_w"):
                p.fill_(1.0)
            elif leaf.endswith("_b") or leaf in ("b1", "b2"):
                p.zero_()
            else:
                r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(r / math.sqrt(p.shape[-2]))

    HF_BLOCK_MAP = {
        "norm1.weight": ("ln1_w", False), "norm1.bias": ("ln1_b", False),
        "norm2.weight": ("ln2_w", False), "norm2.bias": ("ln2_b", False),
        "attn.qkv.weight": ("qkv_w", True), "attn.qkv.bias": ("qkv_b", False),
        "attn.proj.weight": ("proj_w", True), "attn.proj.bias": ("proj_b", False),
        "mlp.fc1.weight": ("fc1", True), "mlp.fc1.bias": ("fc1_b", False),
        "mlp.fc2.weight": ("fc2", True), "mlp.fc2.bias": ("fc2_b", False),
    }
    HF_MERGER_MAP = {
        "merger.ln_q.weight": ("ln_w", False), "merger.ln_q.bias": ("ln_b", False),
        "merger.mlp.0.weight": ("w1", True), "merger.mlp.0.bias": ("b1", False),
        "merger.mlp.2.weight": ("w2", True), "merger.mlp.2.bias": ("b2", False),
    }

    def convert_hf_state(self, state: dict, dtype=None, prefix: str = "") -> dict[str, torch.Tensor]:
        """``visual.*`` tensors (that prefix stripped) as this tower's
        ``state_dict`` entries under ``prefix``."""
        blocks: dict[str, list] = {}
        out: dict[str, torch.Tensor] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if name.startswith("blocks."):
                l, sub = name[len("blocks."):].split(".", 1)
                key, transpose = self.HF_BLOCK_MAP[sub]
                blocks.setdefault(key, [None] * self.depth)[int(l)] = t.T if transpose else t
            elif name == "patch_embed.proj.weight":  # conv3d [E, C, tp, p, p]
                out["patch_w"] = t.reshape(t.shape[0], -1).T
            elif name in self.HF_MERGER_MAP:
                key, transpose = self.HF_MERGER_MAP[name]
                out[f"merger.{key}"] = t.T if transpose else t
            else:
                raise KeyError(f"unmapped vision weight {name}")
        for key, ws in blocks.items():
            out[f"blocks.{key}"] = torch.stack(ws)
        return {
            prefix + k: (v.to(dtype) if dtype is not None else v).contiguous() for k, v in out.items()
        }


class Qwen2VLForConditionalGeneration(LlamaForCausalLM):
    """The Qwen2 decoder (q, k, v biases, multimodal rope) with the ViT under
    ``vision``."""

    is_multimodal = True
    uses_mrope = True
    supports_video = True

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False):
        cfg.attention_bias = True
        super().__init__(cfg, device, dtype, quantization, quantize_lm_head)
        mm = cfg.multimodal or {}
        if "vision_config" not in mm:
            raise ValueError("Qwen2-VL needs multimodal.vision_config")
        self.image_token_index = mm.get("image_token_index", mm.get("image_token_id", 151655))
        self.video_token_index = mm.get("video_token_index", mm.get("video_token_id", 151656))
        self.vision = Qwen2VisionTower(mm["vision_config"], mm.get("image_size", 448), device, dtype)
        if self.mrope_comp is None:
            # checkpoints carry mrope_section; a test config without one takes
            # the official 16:24:24 split of 64, scaled to head_dim
            half = cfg.head_dim // 2
            t = half // 4
            h = (half - t) // 2
            self.set_mrope_section([t, h, half - t - h], device)

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_tokens

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        super().init_random_(generator)
        self.vision.init_random_(generator)

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """HF names, the ``visual.*`` tower and the decoder in either
        layout (``model.visual``, ``model.language_model`` since transformers
        4.52)."""
        lang, vision = {}, {}
        for name, w in state.items():
            n = name
            if n.startswith("model.visual."):
                n = n[len("model."):]
            if n.startswith("model.language_model."):
                n = "model." + n[len("model.language_model."):]
            if n.startswith("visual."):
                vision[n[len("visual."):]] = w
            else:
                lang[n] = w
        out = super().convert_hf_state(lang, dtype)
        out.update(self.vision.convert_hf_state(vision, dtype, prefix="vision."))
        return out

    def encode_images(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> merged patch features [N, tokens, H]."""
        return self.vision(px)

    def encode_video(self, frames: torch.Tensor) -> torch.Tensor:
        """[T, C, S, S] frames -> [grid_t, tokens, H]: ``temporal_patch_size``
        consecutive real frames a temporal patch (HF ``video_grid_thw``), an
        odd tail repeating the last frame."""
        tp = self.vision.tpatch
        pad = (-frames.shape[0]) % tp
        if pad:
            frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
        grid_t = frames.shape[0] // tp
        return self.vision(frames.reshape(grid_t, tp, *frames.shape[1:]))

    def compute_mrope(self, token_ids: list[int], image_spans: list[tuple]) -> tuple[np.ndarray, int]:
        """3-D rope positions [3, L] of a prompt with image and video spans,
        and the shift of every later position (HF ``get_rope_index``; copied
        from the JAX package). ``image_spans``: (start_row, n_tokens) an
        image, or (start_row, n_tokens, t_frames) a video of t_frames grids.
        Text advances all three components; a span's rows take t = frame, h =
        row, w = column; the next segment starts at the largest + 1."""
        L = len(token_ids)
        g = self.vision.llm_grid
        table = np.zeros((3, L), np.int64)
        cur = 0  # next start position
        prev_end = 0  # next row to fill
        for span in image_spans:
            start, n = span[0], span[1]
            tframes = span[2] if len(span) > 2 else 1
            tlen = start - prev_end
            if tlen:
                table[:, prev_end:start] = cur + np.arange(tlen)
                cur += tlen
            per = n // tframes
            assert per == g * g and n == tframes * per, (n, g, tframes)
            rows = np.repeat(np.arange(g), g)
            cols = np.tile(np.arange(g), g)
            for f in range(tframes):
                s = start + f * per
                table[0, s : s + per] = cur + f
                table[1, s : s + per] = cur + rows
                table[2, s : s + per] = cur + cols
            cur += max(tframes, g)  # the largest component + 1
            prev_end = start + n
        if prev_end < L:
            table[:, prev_end:] = cur + np.arange(L - prev_end)
            cur += L - prev_end
        return table.astype(np.int32), int(cur - L)
