"""Image decoding and CLIP-style preprocessing for VLM requests.

Counterpart of ``scratchpad_tpu/multimodal/image.py`` (less Mllama's tiled
preprocessing, whose model is not ported yet). It takes the OpenAI chat
API's ``image_url`` forms that work offline: ``data:`` URLs, raw base64
and local file paths; a remote URL is refused, as the JAX package refuses
it. PIL is imported inside the functions that decode.
"""

from __future__ import annotations

import base64
import binascii
import io
import os

import numpy as np

# OpenAI-CLIP normalisation constants (public, used by LLaVA checkpoints)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class MissingDecoder(ValueError):
    """The library a payload needs (PIL, OpenCV) is not installed."""


def require(module: str, package: str):
    """``import module``, or ``MissingDecoder`` naming ``package``."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError:
        raise MissingDecoder(
            f"decoding this payload needs {package} ({module}), which is not installed"
        ) from None


def decode_image(src):
    """data: URL | base64 string | local path | bytes | PIL.Image -> RGB PIL.Image."""
    Image = require("PIL.Image", "pillow")
    if isinstance(src, Image.Image):
        return src.convert("RGB")
    if isinstance(src, (bytes, bytearray)):
        return Image.open(io.BytesIO(src)).convert("RGB")
    if isinstance(src, str):
        if src.startswith("data:"):
            try:
                return Image.open(io.BytesIO(base64.b64decode(src.split(",", 1)[1]))).convert("RGB")
            except (binascii.Error, OSError, IndexError) as e:
                raise ValueError(f"undecodable image payload: {e}") from None
        if src.startswith(("http://", "https://")):
            raise ValueError(
                "remote image URLs are not fetched (no egress); send a data: URL or base64 payload"
            )
        if os.path.exists(src):
            return Image.open(src).convert("RGB")
        try:
            return Image.open(io.BytesIO(base64.b64decode(src))).convert("RGB")
        except (binascii.Error, OSError) as e:
            raise ValueError(f"undecodable image payload: {e}") from None
    raise TypeError(f"unsupported image source {type(src)}")


def preprocess_clip(img, image_size: int, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """Shortest-side resize (bicubic), centre crop, normalise: f32 [3, S, S]."""
    Image = require("PIL.Image", "pillow")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize(
        (max(image_size, round(w * scale)), max(image_size, round(h * scale))), Image.BICUBIC
    )
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    x = np.asarray(img, np.float32) / 255.0  # [S, S, 3]
    x = (x - mean) / std
    return x.transpose(2, 0, 1)
