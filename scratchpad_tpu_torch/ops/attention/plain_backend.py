"""KV writes and the plain PyTorch attention backend.

Counterpart of ``scratchpad_tpu/ops/attention/xla_backend.py``: ``write_kv``
scatters the new tokens' K/V into the pool (quantizing them first for an
int8 or fp8 pool, with ``quantize_rows``), and the two attention functions
run the kernels' plain PyTorch versions on any device. ``chip_smoke.py``
swaps them into the model to hold the kernel path's logits against them on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention_plain
from scratchpad_tpu_torch.ops.attention.ragged_backend import paged_extend_attention_plain

FP8_FLUSH = 2.0**-6  # the smallest normal e4m3 magnitude


def quantize_rows(x: torch.Tensor, qdtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric 8-bit codes: x [..., D] -> (int8 | float8_e4m3fn
    codes [..., D], bf16 scales [...]), bit for bit the JAX package's
    ``xla_backend._quantize_rows``:

    - amax over the row in f32; scale = max(amax / 127 (int8) or amax / 448
      (e4m3), 1e-8), rounded to bf16 BEFORE the divide, so that code * scale
      uses the stored scale;
    - int8: round half to even, clip at +-127;
    - fp8: |x / scale| below 2**-6 is flushed to zero (the pool never holds a
      sub-normal code), then cast. |x / scale| can reach about 449.75 (the
      bf16 scale rounds down by up to 2**-8), which the cast takes to 448.

    The divisors are tensors: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which would round some scales otherwise."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if qdtype == torch.int8:
        limit = 127.0
    elif qdtype == torch.float8_e4m3fn:
        limit = 448.0
    else:
        raise ValueError(f"quantized KV codes must be int8 or float8_e4m3fn, got {qdtype}")
    scale = torch.clamp_min(amax / torch.full_like(amax, limit), 1e-8)
    scale = scale.to(torch.bfloat16)
    scaled = xf / scale.float()[..., None]
    if qdtype == torch.int8:
        codes = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        scaled = torch.where(scaled.abs() < FP8_FLUSH, torch.zeros_like(scaled), scaled)
        codes = scaled.to(torch.float8_e4m3fn)
    return codes, scale


def write_kv(
    kv: KVCache,
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,
    layer_idx: int,
    out_cache_loc: torch.Tensor,  # i64[T] flat slots of this layer
) -> None:
    """Write the new rows into slot ``out_cache_loc[t]`` of layer
    ``layer_idx``, in place. Padding tokens all target the dump page. A
    quantized pool gets K and V quantized separately, each row with its own
    (token, head) scale."""
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    Hkv, D = k.shape[2], k.shape[3]
    if k_scale is None:
        k.view(-1, Hkv, D).index_copy_(0, out_cache_loc, k_new.to(k.dtype))
        v.view(-1, Hkv, D).index_copy_(0, out_cache_loc, v_new.to(v.dtype))
        return
    codes, scales = quantize_rows(torch.stack([k_new, v_new]), k.dtype)  # [2, T, Hkv, (D)]
    # the scatter moves bytes: index_copy_ has no float8 kernel on the CPU
    for pool, c in ((k, codes[0]), (v, codes[1])):
        pool.view(torch.uint8).view(-1, Hkv, D).index_copy_(0, out_cache_loc, c.view(torch.uint8))
    k_scale.view(-1, Hkv).index_copy_(0, out_cache_loc, scales[0])
    v_scale.view(-1, Hkv).index_copy_(0, out_cache_loc, scales[1])


def decode_attention_plain(
    q: torch.Tensor,
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    return paged_decode_attention_plain(
        q, k, v, meta.page_table, meta.seq_lens, sm_scale, k_scale, v_scale,
        logit_cap, sliding_window, sinks, chunk_size,
    )


def extend_attention_plain(
    q: torch.Tensor,
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    return paged_extend_attention_plain(
        q, k, v, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale, k_scale, v_scale,
        logit_cap, sliding_window, sinks, chunk_size, meta.mm_spans,
    )
