"""Vision towers of the multimodal models, as PyTorch ``nn.Module``s.

Counterpart of ``scratchpad_tpu/models/vision.py``: a CLIP tower (LLaVA: a
class token, a pre-layernorm, quick-GELU MLPs, and the features of a chosen
layer, -2 by default, without the class token) and a SigLIP tower (Gemma 3:
no class token, tanh-GELU MLPs, a post-layernorm over the last layer). The
parameters keep the JAX layout, stacked over the layers (``layers.wq [L,
Hv, Hv]`` in the ``[in, out]`` orientation, ``pre_ln.w``, ...), so the JAX
pytree maps onto the ``state_dict`` by its names alone.

The tower's attention is plain torch, as the JAX package's is XLA: the
scores of all patches against all patches in f32, a softmax, the product
with V. No Pallas kernel is behind it, so no CUDA kernel replaces one; its
f32 scores are the tower's largest workspace (``workspace_bytes``), which
the runner keeps out of the KV pool's budget. A fused attention kernel for
the tower is a redesign candidate (``ROADMAP.md``, Queue 2).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (biased variance, as ``jnp.var``), cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps).to(x.dtype)


def layer_stack(L: int, *shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter [L, *shape], one slice a layer."""
    return nn.Parameter(torch.empty(L, *shape, device=device, dtype=dtype))


def vision_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Bidirectional attention over an image's patches, the JAX tower's
    einsums: ``q, k, v`` [N, P, heads, hd] -> [N, P, heads * hd], scores and
    softmax in f32, the probabilities in the activations' dtype."""
    N, P, heads, hd = q.shape
    s = torch.einsum("nqhd,nkhd->nhqk", q, k).float() * scale
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", a, v).reshape(N, P, heads * hd)


def attention_workspace_bytes(images: int, heads: int, patches: int, itemsize: int) -> int:
    """Bytes the tower's attention holds at once for ``images`` images: the
    f32 scores, their f32 softmax and its copy in the activations' dtype."""
    return images * heads * patches * patches * (4 + 4 + itemsize)


class _EncoderTower(nn.Module):
    """The CLIP and SigLIP encoders' shared part: patch embedding by one
    matmul over flattened (C, ph, pw) patches, and pre-norm encoder layers
    with biased q, k, v, o and a two-layer MLP, stacked over the layers."""

    def __init__(self, vcfg: dict, device, dtype, eps_default: float):
        super().__init__()
        self.hidden = vcfg["hidden_size"]
        self.inter = vcfg["intermediate_size"]
        self.num_layers = vcfg["num_hidden_layers"]
        self.heads = vcfg["num_attention_heads"]
        self.image_size = vcfg["image_size"]
        self.patch = vcfg["patch_size"]
        self.eps = vcfg.get("layer_norm_eps", eps_default)
        self.channels = vcfg.get("num_channels", 3)
        Hv, I, L = self.hidden, self.inter, self.num_layers
        D = self.patch * self.patch * self.channels
        kw = dict(device=device, dtype=dtype)
        self.patch_w = nn.Parameter(torch.empty(D, Hv, **kw))
        self.layers = nn.ParameterDict({
            "ln1_w": layer_stack(L, Hv, **kw), "ln1_b": layer_stack(L, Hv, **kw),
            "ln2_w": layer_stack(L, Hv, **kw), "ln2_b": layer_stack(L, Hv, **kw),
            "wq": layer_stack(L, Hv, Hv, **kw), "bq": layer_stack(L, Hv, **kw),
            "wk": layer_stack(L, Hv, Hv, **kw), "bk": layer_stack(L, Hv, **kw),
            "wv": layer_stack(L, Hv, Hv, **kw), "bv": layer_stack(L, Hv, **kw),
            "wo": layer_stack(L, Hv, Hv, **kw), "bo": layer_stack(L, Hv, **kw),
            "fc1": layer_stack(L, Hv, I, **kw), "fc1_b": layer_stack(L, I, **kw),
            "fc2": layer_stack(L, I, Hv, **kw), "fc2_b": layer_stack(L, Hv, **kw),
        })

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    def patchify(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> [N, g * g, C * p * p], patches in row-major order,
        each flattened as (C, ph, pw) like the conv kernel."""
        N, C, p, g = px.shape[0], self.channels, self.patch, self.grid
        x = px.reshape(N, C, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(N, g * g, C * p * p).to(self.patch_w.dtype)

    def run_layers(self, x: torch.Tensor, n: int, act) -> torch.Tensor:
        N, P, Hv = x.shape
        heads = self.heads
        hd = Hv // heads
        lp = self.layers
        for l in range(n):
            y = layer_norm(x, lp["ln1_w"][l], lp["ln1_b"][l], self.eps)
            q = (y @ lp["wq"][l] + lp["bq"][l]).view(N, P, heads, hd)
            k = (y @ lp["wk"][l] + lp["bk"][l]).view(N, P, heads, hd)
            v = (y @ lp["wv"][l] + lp["bv"][l]).view(N, P, heads, hd)
            x = x + (vision_attention(q, k, v, hd**-0.5) @ lp["wo"][l] + lp["bo"][l])
            y = layer_norm(x, lp["ln2_w"][l], lp["ln2_b"][l], self.eps)
            x = x + (act(y @ lp["fc1"][l] + lp["fc1_b"][l]) @ lp["fc2"][l] + lp["fc2_b"][l])
        return x

    def workspace_bytes(self, images: int) -> int:
        """Peak bytes beside the weights for ``images`` images at once: the
        attention's scores and the MLP's hidden rows, in f32."""
        P = self.grid**2 + 1
        itemsize = self.patch_w.element_size()
        mlp = images * P * self.inter * 4
        return attention_workspace_bytes(images, self.heads, P, itemsize) + mlp

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX package's scheme: matrices normal / sqrt(fan_in), the
        embeddings normal / sqrt(Hv), norms at one, biases at zero."""
        for name, p in self.named_parameters():
            if name in ("layers.ln1_w", "layers.ln2_w", "pre_ln.w", "post_ln.w", "ln_w"):
                p.fill_(1.0)
            elif name.endswith(("_b", ".b")) or name.split(".")[-1] in ("bq", "bk", "bv", "bo"):
                p.zero_()
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 and "emb" not in name else self.hidden
                r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(r / math.sqrt(fan_in))

    HF_LAYER_MAP = {
        "layer_norm1.weight": "ln1_w", "layer_norm1.bias": "ln1_b",
        "layer_norm2.weight": "ln2_w", "layer_norm2.bias": "ln2_b",
        "self_attn.q_proj.weight": "wq", "self_attn.q_proj.bias": "bq",
        "self_attn.k_proj.weight": "wk", "self_attn.k_proj.bias": "bk",
        "self_attn.v_proj.weight": "wv", "self_attn.v_proj.bias": "bv",
        "self_attn.out_proj.weight": "wo", "self_attn.out_proj.bias": "bo",
        "mlp.fc1.weight": "fc1", "mlp.fc1.bias": "fc1_b",
        "mlp.fc2.weight": "fc2", "mlp.fc2.bias": "fc2_b",
    }

    def _convert_other(self, name: str, w: torch.Tensor, out: dict) -> None:
        raise KeyError(f"unmapped vision weight {name}")

    def convert_hf_state(self, state: dict, dtype=None, prefix: str = "") -> dict[str, torch.Tensor]:
        """``vision_model.*`` tensors (that prefix stripped) as this tower's
        ``state_dict`` entries under ``prefix``: linear weights transposed to
        ``[in, out]`` and stacked over the layers, the patch conv flattened
        to ``[C * p * p, Hv]``."""
        L = self.num_layers
        per_layer: dict[str, list] = {}
        out: dict[str, torch.Tensor] = {}
        for name, w in state.items():
            t = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w)
            if name.startswith("encoder.layers."):
                l, sub = name[len("encoder.layers."):].split(".", 1)
                if sub not in self.HF_LAYER_MAP:
                    raise KeyError(f"unmapped vision weight {name}")
                per_layer.setdefault(self.HF_LAYER_MAP[sub], [None] * L)[int(l)] = (
                    t.T if sub.endswith("weight") and "norm" not in sub else t
                )
            elif name == "embeddings.patch_embedding.weight":
                out["patch_w"] = t.reshape(t.shape[0], -1).T
            elif name == "embeddings.position_ids":
                pass
            else:
                self._convert_other(name, t, out)
        for key, ws in per_layer.items():
            if any(w is None for w in ws):
                raise KeyError(f"vision {key}: missing layers")
            out[f"layers.{key}"] = torch.stack(ws)
        return {
            prefix + k: (v.to(dtype) if dtype is not None else v).contiguous() for k, v in out.items()
        }


class CLIPVisionTower(_EncoderTower):
    """HF ``CLIPVisionModel`` up to ``feature_layer`` (-k: all but the last
    k - 1 layers; no post-layernorm), the class token dropped where
    ``select`` is ``default``."""

    def __init__(self, vcfg: dict, device, dtype, feature_layer: int = -2, select: str = "default"):
        super().__init__(vcfg, device, dtype, eps_default=1e-5)
        L = self.num_layers
        self.n_run = L + feature_layer + 1 if feature_layer < 0 else feature_layer
        assert 0 < self.n_run <= L
        self.select = select
        Hv, kw = self.hidden, dict(device=device, dtype=dtype)
        self.class_emb = nn.Parameter(torch.empty(Hv, **kw))
        self.pos_emb = nn.Parameter(torch.empty(self.grid**2 + 1, Hv, **kw))
        self.pre_ln = nn.ParameterDict({"w": nn.Parameter(torch.empty(Hv, **kw)),
                                        "b": nn.Parameter(torch.empty(Hv, **kw))})

    @property
    def num_patches(self) -> int:
        n = self.grid**2
        return n if self.select == "default" else n + 1

    def forward(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> the feature layer's hidden [N, P(+1), Hv]."""
        x = self.patchify(px) @ self.patch_w
        cls = self.class_emb.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_emb
        x = layer_norm(x, self.pre_ln["w"], self.pre_ln["b"], self.eps)
        x = self.run_layers(x, self.n_run, quick_gelu)
        return x[:, 1:] if self.select == "default" else x

    def _convert_other(self, name, w, out) -> None:
        if name == "embeddings.class_embedding":
            out["class_emb"] = w
        elif name == "embeddings.position_embedding.weight":
            out["pos_emb"] = w
        elif name in ("pre_layrnorm.weight", "pre_layrnorm.bias"):  # (sic) HF CLIP
            out["pre_ln." + ("w" if name.endswith("weight") else "b")] = w
        elif name in ("post_layernorm.weight", "post_layernorm.bias"):
            pass  # the feature layer never reaches it
        else:
            super()._convert_other(name, w, out)


class SigLIPVisionTower(_EncoderTower):
    """HF ``SiglipVisionModel`` (Gemma 3's tower): a biased patch embedding,
    no class token, tanh-GELU MLPs, the last layer through the
    post-layernorm."""

    def __init__(self, vcfg: dict, device, dtype):
        super().__init__(vcfg, device, dtype, eps_default=1e-6)
        Hv, kw = self.hidden, dict(device=device, dtype=dtype)
        self.patch_b = nn.Parameter(torch.empty(Hv, **kw))
        self.pos_emb = nn.Parameter(torch.empty(self.grid**2, Hv, **kw))
        self.post_ln = nn.ParameterDict({"w": nn.Parameter(torch.empty(Hv, **kw)),
                                         "b": nn.Parameter(torch.empty(Hv, **kw))})

    @property
    def num_patches(self) -> int:
        return self.grid**2

    def forward(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> post-layernormed hidden [N, P, Hv]."""
        x = self.patchify(px) @ self.patch_w + self.patch_b + self.pos_emb
        x = self.run_layers(x, self.num_layers, lambda y: F.gelu(y, approximate="tanh"))
        return layer_norm(x, self.post_ln["w"], self.post_ln["b"], self.eps)

    def _convert_other(self, name, w, out) -> None:
        if name == "embeddings.patch_embedding.bias":
            out["patch_b"] = w
        elif name == "embeddings.position_embedding.weight":
            out["pos_emb"] = w
        elif name in ("post_layernorm.weight", "post_layernorm.bias"):
            out["post_ln." + ("w" if name.endswith("weight") else "b")] = w
        else:
            super()._convert_other(name, w, out)
