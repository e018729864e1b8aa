"""LLaVA: a CLIP vision tower, a two-layer projector and the Llama decoder.

Counterpart of ``scratchpad_tpu/models/llava.py``. The tower (``vision``,
``models/vision.py``) and the projector (``projector``: ``w1 [Hv, H]``,
``b1``, ``w2 [H, H]``, ``b2``, exact GELU between) run as their own step,
``encode_images``, when the engine admits a request; the engine splices
the projected features into the prompt's embedding rows under negative,
content-hashed placeholder ids, and the decoder is the Llama decoder
unchanged (``embed_tokens`` takes the features on those rows).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.models.vision import CLIPVisionTower


class LlavaForConditionalGeneration(LlamaForCausalLM):
    is_multimodal = True

    def __init__(self, cfg: ModelConfig, device, dtype, quantization=None, quantize_lm_head=False):
        super().__init__(cfg, device, dtype, quantization, quantize_lm_head)
        mm = cfg.multimodal or {}
        if "vision_config" not in mm:
            raise ValueError("LLaVA needs multimodal.vision_config")
        self.image_token_index = mm.get("image_token_index", 32000)
        self.vision = CLIPVisionTower(
            mm["vision_config"], device, dtype,
            feature_layer=mm.get("vision_feature_layer", -2),
            select=mm.get("vision_feature_select_strategy", "default"),
        )
        H, Hv = cfg.hidden_size, self.vision.hidden
        kw = dict(device=device, dtype=dtype)
        self.projector = nn.ParameterDict({
            "w1": nn.Parameter(torch.empty(Hv, H, **kw)), "b1": nn.Parameter(torch.empty(H, **kw)),
            "w2": nn.Parameter(torch.empty(H, H, **kw)), "b2": nn.Parameter(torch.empty(H, **kw)),
        })

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        super().init_random_(generator)
        self.vision.init_random_(generator)
        for name, p in self.projector.items():
            if name.startswith("b"):
                p.zero_()
            else:
                r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(r / math.sqrt(p.shape[0]))

    def convert_hf_state(self, state: dict, dtype=None) -> dict[str, torch.Tensor]:
        """HF ``LlavaForConditionalGeneration`` names, both nestings
        (``language_model.model.*`` and, since transformers 4.52,
        ``model.language_model.*``)."""
        lang, vision, proj = {}, {}, {}
        for name, w in state.items():
            n = name[len("model."):] if name.startswith("model.") else name
            if n.startswith("vision_tower.vision_model."):
                vision[n[len("vision_tower.vision_model."):]] = w
            elif n.startswith("multi_modal_projector."):
                proj[n[len("multi_modal_projector."):]] = w
            elif n.startswith("language_model."):
                rest = n[len("language_model."):]
                if rest.startswith("model.") or rest == "lm_head.weight":
                    lang[rest] = w  # older nesting: language_model.model.*
                else:
                    lang["model." + rest] = w
            elif n == "lm_head.weight":
                lang["lm_head.weight"] = w
            else:
                raise KeyError(f"unmapped HF weight {name}")
        out = super().convert_hf_state(lang, dtype)
        out.update(self.vision.convert_hf_state(vision, dtype, prefix="vision."))
        for key, hf, transpose in (("w1", "linear_1.weight", True), ("b1", "linear_1.bias", False),
                                   ("w2", "linear_2.weight", True), ("b2", "linear_2.bias", False)):
            t = torch.as_tensor(np.asarray(proj[hf]) if not torch.is_tensor(proj[hf]) else proj[hf])
            t = t.T if transpose else t
            out[f"projector.{key}"] = (t.to(dtype) if dtype is not None else t).contiguous()
        return out

    def encode_images(self, px: torch.Tensor) -> torch.Tensor:
        """[N, C, S, S] -> projected features [N, num_patches, H]."""
        feats = self.vision(px)
        pr = self.projector
        h = F.gelu(feats @ pr["w1"] + pr["b1"])
        return h @ pr["w2"] + pr["b2"]
