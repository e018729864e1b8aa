"""KV writes and the plain PyTorch attention backend.

Counterpart of ``scratchpad_tpu/ops/attention/xla_backend.py``: ``write_kv``
scatters the new tokens' K/V into the pool, and the two attention functions
run the kernels' plain PyTorch versions on any device. ``chip_smoke.py``
swaps them into the model to hold the kernel path's logits against them on
the card.
"""

from __future__ import annotations

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention_plain
from scratchpad_tpu_torch.ops.attention.ragged_backend import paged_extend_attention_plain


def write_kv(
    kv: KVCache,
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,
    layer_idx: int,
    out_cache_loc: torch.Tensor,  # i64[T] flat slots of this layer
) -> None:
    """Write the new rows into slot ``out_cache_loc[t]`` of layer
    ``layer_idx``, in place. Padding tokens all target the dump page."""
    k, v = kv.layer(layer_idx)
    Hkv, D = k.shape[2], k.shape[3]
    k.view(-1, Hkv, D).index_copy_(0, out_cache_loc, k_new.to(k.dtype))
    v.view(-1, Hkv, D).index_copy_(0, out_cache_loc, v_new.to(v.dtype))


def decode_attention_plain(
    q: torch.Tensor, kv: KVCache, layer_idx: int, meta: ForwardMeta, *, sm_scale: float
) -> torch.Tensor:
    k, v = kv.layer(layer_idx)
    return paged_decode_attention_plain(
        q, k, v, meta.page_table, meta.seq_lens, sm_scale
    )


def extend_attention_plain(
    q: torch.Tensor, kv: KVCache, layer_idx: int, meta: ForwardMeta, *, sm_scale: float
) -> torch.Tensor:
    k, v = kv.layer(layer_idx)
    return paged_extend_attention_plain(
        q, k, v, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale
    )
