"""Paged decode attention of ``attention_backend="pallas"``.

Counterpart of ``scratchpad_tpu/ops/attention/pallas_decode.py``, whose
Pallas ``_decode_kernel`` is a per-request paged flash-decode with a soft cap
and a static sliding window over bf16 pages. It computes the same function
as ``gqa_decode._gqa_decode_kernel``; the two differ only in how a TPU core
schedules its page DMAs (one grid step per request, one DMA per whole page,
double-buffered 8-page chunks). On the GPU the decode kernel's grid of
(split, kv head, row) CTAs already serves every request in parallel, so
``_decode_kernel`` is ported as the same hand-written CUDA kernel,
``csrc/paged_decode_attention.cu``, reached through this wrapper with its
own launch count.
"""

from __future__ import annotations

from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention


def decode_attention_pallas(
    q: torch.Tensor,  # [B, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Model-facing decode attention over one layer of a bf16 pool, the
    contract of ``decode_attention_gqa``: the plain version for CPU tensors,
    the decode kernel for CUDA tensors. An 8-bit pool raises, as the JAX
    wrapper asserts (``pallas_decode.py:206``)."""
    k, v, k_scale, _ = kv.layer(layer_idx)
    if k_scale is not None:
        raise TypeError(
            f"decode_attention_pallas takes bf16 pages, not {k.dtype} codes "
            "(int8 and fp8 KV decode through decode_attention_gqa)"
        )
    out = paged_decode_attention(
        q, k, v, meta.page_table, meta.seq_lens, sm_scale, logit_cap, sliding_window
    )
    if q.device.type == "cuda":  # the wrapper above launched the kernel
        decode_attention_pallas.launches += 1
    return out


decode_attention_pallas.launches = 0
