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

A latent pool (``mla``, DeepSeek's multi-head latent attention) holds one
vector a token and layer, ``[c_kv (kv_lora_rank) | k_rope
(qk_rope_head_dim)]``, in ``k`` as ``[num_layers, num_pages, page_size, 1,
r + dr]``, and no V: the JAX package's ``MLATokenToKVPool`` layout
(``memory/kv_cache.py:86-89``), one head of width r + dr. An 8-bit latent
pool is refused, as the JAX runner refuses it (``model_runner.py:709-711``).

A cross-attention model (Mllama) keeps the paged pool for its self layers
only and its images' K and V in ``KVCache.cross``, ``[cross_slots,
cross_layers, cross_len, 2 Hkv, D]`` in the model dtype (a head's K at row
2h, its V at 2h + 1, as the JAX pool's), one slot a running request with
an image and slot 0 unused (JAX ``memory/kv_cache.py:90-95, 318-330``).

A tensor-parallel rank's pool holds its Hkv / tp heads (and their scales):
the layout is per head already, so the JAX ``scale_shards`` lane blocks
(``memory/kv_cache.py:133-149``, a workaround for the TPU's lanes) have no
counterpart; the runner sizes every rank's pool to the same page count.

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
    # a latent pool: one [c_kv | k_rope] row a token and layer (num_kv_heads
    # 1, head_dim r + dr), no V
    mla: bool = False
    # cross-attention K/V slots (Mllama): layers, rows a slot, slots (the
    # unused slot 0 included); 0 layers: none
    cross_layers: int = 0
    cross_len: int = 0
    cross_slots: int = 0

    def __post_init__(self):
        if self.mla and self.quantized:
            raise NotImplementedError(
                "an 8-bit latent (MLA) pool is not supported, as in the JAX package; "
                "use kv_cache_dtype='auto' or the model dtype"
            )
        if self.mla and self.num_kv_heads != 1:
            raise ValueError(f"a latent pool holds one row a token, not {self.num_kv_heads} heads")
        if self.quantized:
            check_quant_kv_head_dim(self.head_dim)

    @property
    def num_slots(self) -> int:
        """Token slots per layer."""
        return self.num_pages * self.page_size

    def bytes_per_token(self) -> int:
        """K and V of one token over every layer, scales included:
        2 L Hkv (D + 2) bytes for a quantized pool; a latent pool's one row
        a layer, L (r + dr) itemsize."""
        if self.mla:
            return self.num_layers * self.head_dim * self.dtype.itemsize
        rows = 2 * self.num_layers * self.num_kv_heads
        if self.quantized:
            return rows * (self.head_dim + SCALE_DTYPE.itemsize)
        return rows * self.head_dim * self.dtype.itemsize

    def cross_bytes(self) -> int:
        """The cross-attention buffer's bytes (0 without one)."""
        return (
            self.cross_slots * self.cross_layers * self.cross_len * 2 * self.num_kv_heads
            * self.head_dim * self.dtype.itemsize
        )


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, num_pages, ps, Hkv, D]; a latent pool's rows
    v: Optional[torch.Tensor]  # [L, num_pages, ps, Hkv, D]; None in a latent pool
    k_scale: Optional[torch.Tensor] = None  # bf16 [L, num_pages, ps, Hkv]
    v_scale: Optional[torch.Tensor] = None
    # [slots, cross layers, S_img, 2 Hkv, D]: a cross-attention model's
    # image K and V (None otherwise)
    cross: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def mla(self) -> bool:
        """A latent pool: ``k`` holds ``[c_kv | k_rope]`` rows, no V."""
        return self.v is None

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
        if self.mla:
            raise ValueError("a latent (MLA) pool has no K and V; ops/attention/mla_backend.py reads it")
        if not self.quantized:
            return self.k[layer_idx], self.v[layer_idx], None, None
        return (
            self.k[layer_idx],
            self.v[layer_idx],
            self.k_scale[layer_idx],
            self.v_scale[layer_idx],
        )


def create_kv_cache(cfg: KVCacheConfig, device: torch.device) -> KVCache:
    kv = _create_pool(cfg, device)
    if cfg.cross_layers:
        kv.cross = torch.zeros(
            (cfg.cross_slots, cfg.cross_layers, cfg.cross_len, 2 * cfg.num_kv_heads, cfg.head_dim),
            dtype=cfg.dtype, device=device,
        )
    return kv


def _create_pool(cfg: KVCacheConfig, device: torch.device) -> KVCache:
    shape = (
        cfg.num_layers,
        cfg.num_pages,
        cfg.page_size,
        cfg.num_kv_heads,
        cfg.head_dim,
    )
    if cfg.mla:
        return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device), v=None)
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
