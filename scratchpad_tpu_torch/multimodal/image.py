"""Image decoding and CLIP-style preprocessing for VLM requests.

Counterpart of ``scratchpad_tpu/multimodal/image.py``: CLIP's square crop,
and Mllama's tiles (``select_tiling``, ``preprocess_tiled``: HF
``MllamaImageProcessor``'s canvas, the tiles equal to the JAX package's
bit for bit). It takes the OpenAI chat API's ``image_url`` forms that work
offline: ``data:`` URLs, raw base64 and local file paths; a remote URL is
refused, as the JAX package refuses it. PIL is imported inside the
functions that decode.
"""

from __future__ import annotations

import base64
import binascii
import io
import math
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


def select_tiling(w: int, h: int, tile_size: int, supported) -> tuple[int, int, int]:
    """The tile grid for a ``w`` x ``h`` image, as HF's
    ``get_optimal_tiled_canvas`` picks it: of the ``supported`` (rows,
    columns) grids, the smallest upscale that fits the image, else the
    largest downscale, ties to the smaller canvas. Returns (aspect-ratio id,
    1-based, rows, columns)."""
    best = None
    for i, (th, tw) in enumerate(supported):
        ch, cw = th * tile_size, tw * tile_size
        scale = min(cw / w, ch / h)
        key = (0, scale, ch * cw) if scale >= 1 else (1, -scale, ch * cw)
        if best is None or key < best[0]:
            best = (key, i + 1, th, tw)
    return best[1], best[2], best[3]


def preprocess_tiled(img, tile_size: int, supported, max_tiles: int, mean=CLIP_MEAN, std=CLIP_STD):
    """HF ``MllamaImageProcessor``: resize into the chosen tile canvas with
    the aspect kept (bilinear, the other side floored), pad with zeros,
    normalise, split into row-major tiles, and zero-pad the stack to
    ``max_tiles``. Returns (tiles f32 [max_tiles, 3, S, S], aspect-ratio id
    (1-based), live tiles)."""
    Image = require("PIL.Image", "pillow")
    w, h = img.size
    ar_id, th, tw = select_tiling(w, h, tile_size, supported)
    ch, cw = th * tile_size, tw * tile_size
    # HF get_image_size_fit_to_canvas: the target clamped into [tile_size,
    # canvas], scaled by the binding side, the other side floored
    tgt_w = min(max(w, tile_size), cw)
    tgt_h = min(max(h, tile_size), ch)
    scale_w, scale_h = tgt_w / w, tgt_h / h
    if scale_w < scale_h:
        nw, nh = tgt_w, min(math.floor(h * scale_w) or 1, tgt_h)
    else:
        nw, nh = min(math.floor(w * scale_h) or 1, tgt_w), tgt_h
    img = img.resize((nw, nh), Image.BILINEAR)
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:nh, :nw] = np.asarray(img, np.float32) / 255.0
    x = ((canvas - mean) / std).transpose(2, 0, 1)  # [3, ch, cw]
    n = th * tw
    out = np.zeros((max_tiles, 3, tile_size, tile_size), np.float32)
    out[:n] = (
        x.reshape(3, th, tile_size, tw, tile_size).transpose(1, 3, 0, 2, 4).reshape(n, 3, tile_size, tile_size)
    )
    return out, ar_id, n
