"""Device-side paged KV cache for the PyTorch port.

Counterpart of ``scratchpad_tpu/memory/kv_cache.py``. The layout is chosen
for the CUDA kernels, not for Mosaic's (8, 128) tiling:

    k, v : [num_layers, num_pages, page_size, num_kv_heads, head_dim]

one tensor for K and one for V, each layer a contiguous block. Token slot
``s = page * page_size + offset`` is row ``s`` of
``k[layer].view(-1, num_kv_heads, head_dim)``. There is no lane padding, no
packed K|V row and no inline scale plane: those existed only so that TPU
page DMAs stayed tile aligned. ``weight_loader.kv_cache_from_jax`` converts
a JAX pool into this layout, code for code.

A quantized pool (``kv_cache_dtype`` int8 or fp8) keeps the layout with
int8 or float8_e4m3fn codes in ``k`` and ``v``, and adds one bf16 scale per
(token, head) for each of K and V:

    k_scale, v_scale : [num_layers, num_pages, page_size, num_kv_heads]

so that slot ``s`` of head ``h`` holds ``k[s, h, :] * k_scale[s, h]``. This
is the JAX pool's per-(token, head slot) scale, which it keeps as
interleaved ``[k0, v0, k1, v1, ...]`` lanes of one padded scale array.

Writes update the pool in place (``ops/attention/plain_backend.write_kv``):
PyTorch tensors are mutable, so the port keeps one pool for the engine's
lifetime instead of threading a new array through every step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# kv_cache_dtype -> the code dtype of a quantized pool
QUANT_KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
SCALE_DTYPE = torch.bfloat16
# the head_dims the attention kernels take over 8-bit pages (256: Gemma)
QUANT_KV_HEAD_DIMS = (32, 64, 128, 256)


def check_quant_kv_head_dim(head_dim: int) -> None:
    """Refuse an 8-bit pool at a head_dim the 8-bit kernels do not take."""
    if head_dim not in QUANT_KV_HEAD_DIMS:
        raise NotImplementedError(
            f"kv_cache_dtype int8 or fp8 at head_dim {head_dim} is not supported "
            f"(8-bit pages take head_dim {QUANT_KV_HEAD_DIMS}); use bfloat16 KV"
        )


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_pages: int  # per layer, including the reserved dump page 0
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16
    quantized: bool = False  # 8-bit codes plus per-(token, head) bf16 scales
    quant_dtype: torch.dtype = torch.int8  # int8 | float8_e4m3fn

    def __post_init__(self):
        if self.quantized:
            check_quant_kv_head_dim(self.head_dim)

    @property
    def num_slots(self) -> int:
        """Token slots per layer."""
        return self.num_pages * self.page_size

    def bytes_per_token(self) -> int:
        """K and V of one token over every layer, scales included:
        2 L Hkv (D + 2) bytes for a quantized pool."""
        rows = 2 * self.num_layers * self.num_kv_heads
        if self.quantized:
            return rows * (self.head_dim + SCALE_DTYPE.itemsize)
        return rows * self.head_dim * self.dtype.itemsize


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, num_pages, ps, Hkv, D]
    v: torch.Tensor  # [L, num_pages, ps, Hkv, D]
    k_scale: Optional[torch.Tensor] = None  # bf16 [L, num_pages, ps, Hkv]
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    def layer(self, layer_idx: int):
        """Contiguous views of one layer: K and V ``[num_pages, ps, Hkv,
        D]`` and their scales ``[num_pages, ps, Hkv]`` (None for a pool
        that is not quantized)."""
        if not self.quantized:
            return self.k[layer_idx], self.v[layer_idx], None, None
        return (
            self.k[layer_idx],
            self.v[layer_idx],
            self.k_scale[layer_idx],
            self.v_scale[layer_idx],
        )


def create_kv_cache(cfg: KVCacheConfig, device: torch.device) -> KVCache:
    shape = (
        cfg.num_layers,
        cfg.num_pages,
        cfg.page_size,
        cfg.num_kv_heads,
        cfg.head_dim,
    )
    if not cfg.quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        )
    if cfg.quant_dtype not in QUANT_KV_DTYPES.values():
        raise ValueError(f"quantized KV codes must be int8 or float8_e4m3fn, got {cfg.quant_dtype}")
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.quant_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.quant_dtype, device=device),
        k_scale=torch.zeros(shape[:-1], dtype=SCALE_DTYPE, device=device),
        v_scale=torch.zeros(shape[:-1], dtype=SCALE_DTYPE, device=device),
    )
