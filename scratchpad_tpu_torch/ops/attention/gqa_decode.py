"""Paged GQA decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``scratchpad_tpu/ops/attention/gqa_decode.py``, whose two
Pallas kernels (``_gqa_decode_kernel`` and ``_gqa_decode_grouped_kernel``)
become one hand-written CUDA kernel, ``csrc/paged_decode_attention.cu``.

``paged_decode_attention`` takes the plain PyTorch version for CPU tensors
and launches the kernel for CUDA tensors, raising on anything the kernel
does not take; it never falls back. ``sm_scale`` is applied once, inside
(the JAX callers pre-scale q instead).
"""

from __future__ import annotations

import ctypes

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_decode_attention": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # i32[B, P]
    seq_lens: torch.Tensor,  # i32[B]
    sm_scale: float,
) -> torch.Tensor:
    """Gather each row's pages into dense K/V and attend in f32. Rows with
    ``seq_len == 0`` give exact zeros, like the kernel."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    P = page_table.shape[1]
    offs = torch.arange(ps, device=q.device)
    slots = (page_table.long()[:, :, None] * ps + offs).reshape(B, P * ps)
    k = k_cache.reshape(-1, Hkv, D)[slots].float()  # [B, S, Hkv, D]
    v = v_cache.reshape(-1, Hkv, D)[slots].float()
    qg = q.float().reshape(B, Hkv, G, D) * sm_scale
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k)
    valid = torch.arange(P * ps, device=q.device)[None, :] < seq_lens[:, None]
    valid = valid[:, None, None, :]
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))  # len-0 rows
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def _check(q, k_cache, v_cache, page_table, seq_lens) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the decode kernel takes bf16 {name}, got {t.dtype}")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    B, Hq, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[3] != D:
        raise ValueError(f"k/v caches must be [pages, ps, Hkv, {D}], got {tuple(k_cache.shape)}")
    Hkv = k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be 1..{MAX_GROUP} times Hkv={Hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and seq_lens [B]")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """out [B, Hq, D]: each row's single query over its ``seq_lens`` cached
    tokens (see ``csrc/paged_decode_attention.cu``)."""
    native.check_same_device(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, page_table, seq_lens, sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, k_cache.shape[2], D, page_table.shape[1], k_cache.shape[1],
        float(sm_scale), native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention_gqa(
    q: torch.Tensor,  # [B, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Model-facing decode attention over one layer of the pool."""
    k, v = kv.layer(layer_idx)
    return paged_decode_attention(q, k, v, meta.page_table, meta.seq_lens, sm_scale)
