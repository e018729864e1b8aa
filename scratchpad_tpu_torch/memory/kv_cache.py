"""Device-side paged KV cache for the PyTorch port.

Counterpart of ``scratchpad_tpu/memory/kv_cache.py``. The layout is chosen
for the CUDA kernels, not for Mosaic's (8, 128) tiling:

    k, v : [num_layers, num_pages, page_size, num_kv_heads, head_dim]

one tensor for K and one for V, each layer a contiguous block. Token slot
``s = page * page_size + offset`` is row ``s`` of
``k[layer].view(-1, num_kv_heads, head_dim)``. There is no lane padding, no
packed K|V row and no inline scale plane: those existed only so that TPU
page DMAs stayed tile aligned. Parity with the JAX pool is held on attention
outputs, never on pool bytes.

Writes update the pool in place (``ops/attention/plain_backend.write_kv``):
PyTorch tensors are mutable, so the port keeps one pool for the engine's
lifetime instead of threading a new array through every step.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_pages: int  # per layer, including the reserved dump page 0
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_slots(self) -> int:
        """Token slots per layer."""
        return self.num_pages * self.page_size

    def bytes_per_token(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * itemsize


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, num_pages, ps, Hkv, D]
    v: torch.Tensor  # [L, num_pages, ps, Hkv, D]

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

    def layer(self, layer_idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Contiguous [num_pages, ps, Hkv, D] views of one layer's K and V."""
        return self.k[layer_idx], self.v[layer_idx]


def create_kv_cache(cfg: KVCacheConfig, device: torch.device) -> KVCache:
    shape = (
        cfg.num_layers,
        cfg.num_pages,
        cfg.page_size,
        cfg.num_kv_heads,
        cfg.head_dim,
    )
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
    )
