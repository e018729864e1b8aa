"""Paged GQA decode attention: the CUDA kernel's wrappers and their plain version.

Counterpart of ``scratchpad_tpu/ops/attention/gqa_decode.py``, whose two
Pallas kernels (``_gqa_decode_kernel`` and ``_gqa_decode_grouped_kernel``)
become one hand-written CUDA kernel, ``csrc/paged_decode_attention.cu``,
built for bf16 pages and for int8 and fp8 (e4m3) pages with per-(token,
head) bf16 scales, the Pallas kernels' ``quantized`` branch.

``paged_decode_attention`` (bf16 pages) and ``paged_decode_attention_quant``
(8-bit pages) take the plain PyTorch version for CPU tensors and launch the
kernel for CUDA tensors, raising on anything the kernel does not take; they
never fall back. ``sm_scale`` is applied once, inside (the JAX callers
pre-scale q instead).

Both take the Pallas kernels' static ``logit_cap`` and ``sliding_window``
(``gqa_decode.py:171-172, 395-396``): the score is ``cap * tanh(s / cap)``
with ``s = sm_scale * q . k`` (for 8-bit pages, ``s`` already holds the K
scale), and token ``j`` of a row of length ``L`` is live iff ``L - W <= j <
L``. The kernel starts its token loop at ``max(L - W, 0)``, so it reads only
the window.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import SCALE_DTYPE, KVCache
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_decode_attention": (
        [_P] * 6 + [_I] * 6 + [ctypes.c_float, ctypes.c_float, _I, _P],
        ctypes.c_int,
    ),
    "paged_decode_attention_quant": (
        [_P] * 8 + [_I] * 7 + [ctypes.c_float, ctypes.c_float, _I, _P],
        ctypes.c_int,
    ),
}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
# code dtype -> the kernel's code type argument
CODE_TYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def mask_args(logit_cap: Optional[float], sliding_window: Optional[int]) -> tuple[float, int]:
    """The kernels' runtime form of the cap and the window: 0 for none."""
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be None or > 0, got {logit_cap}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be None or >= 1, got {sliding_window}")
    return float(logit_cap or 0.0), int(sliding_window or 0)


def softcap(scores: torch.Tensor, logit_cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(s / cap)``, as ``xla_backend._softcap``."""
    if logit_cap is None:
        return scores
    return logit_cap * torch.tanh(scores / logit_cap)


def gather_kv_rows(
    cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    scale: Optional[torch.Tensor],  # [pages, ps, Hkv] or None
    slots: torch.Tensor,  # i64 flat slots, any shape
) -> torch.Tensor:
    """The rows at ``slots`` in f32 [..., Hkv, D]: bf16 values as they are,
    8-bit codes times their (token, head) scale."""
    Hkv, D = cache.shape[2], cache.shape[3]
    if scale is None:
        return cache.reshape(-1, Hkv, D)[slots].float()
    # gather bytes: not every indexing kernel takes float8
    codes = cache.view(torch.uint8).reshape(-1, Hkv, D)[slots].view(cache.dtype)
    return codes.float() * scale.reshape(-1, Hkv)[slots].float()[..., None]


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # i32[B, P]
    seq_lens: torch.Tensor,  # i32[B]
    sm_scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [pages, ps, Hkv] for 8-bit pages
    v_scale: Optional[torch.Tensor] = None,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Gather each row's pages into dense K/V (dequantized in f32 for 8-bit
    pages) and attend in f32, the cap and the window as in the module
    docstring. Rows with ``seq_len == 0`` give exact zeros, like the
    kernel."""
    mask_args(logit_cap, sliding_window)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    P = page_table.shape[1]
    offs = torch.arange(ps, device=q.device)
    slots = (page_table.long()[:, :, None] * ps + offs).reshape(B, P * ps)
    k = gather_kv_rows(k_cache, k_scale, slots)  # [B, S, Hkv, D]
    v = gather_kv_rows(v_cache, v_scale, slots)
    qg = q.float().reshape(B, Hkv, G, D) * sm_scale
    scores = softcap(torch.einsum("bhgd,bshd->bhgs", qg, k), logit_cap)
    pos = torch.arange(P * ps, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]
    if sliding_window is not None:
        valid &= pos >= seq_lens[:, None] - sliding_window
    valid = valid[:, None, None, :]
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))  # len-0 rows
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def check_pages(q, k_cache, v_cache, k_scale, v_scale, max_group: int) -> None:
    """What both attention kernels take: contiguous bf16 q and pages, or
    int8 / e4m3 pages with contiguous bf16 scales ``[pages, ps, Hkv]``;
    head_dim in ``HEAD_DIMS``; 1..``max_group`` query heads per kv head."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bf16 q, got {q.dtype}")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError(f"k_cache {k_cache.dtype} and v_cache {v_cache.dtype} differ")
    D = q.shape[-1]
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[3] != D:
        raise ValueError(f"k/v caches must be [pages, ps, Hkv, {D}], got {tuple(k_cache.shape)}")
    if k_scale is None:
        if k_cache.dtype != torch.bfloat16:
            raise TypeError(f"bf16 pages expected, got {k_cache.dtype}")
    else:
        if k_cache.dtype not in CODE_TYPES:
            raise TypeError(f"8-bit pages must be int8 or float8_e4m3fn, got {k_cache.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != SCALE_DTYPE:
                raise TypeError(f"{name} must be bf16, got {None if t is None else t.dtype}")
            if t.shape != k_cache.shape[:3]:
                raise ValueError(f"{name} must be {tuple(k_cache.shape[:3])}, got {tuple(t.shape)}")
    Hq, Hkv = q.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= max_group:
        raise ValueError(f"Hq={Hq} must be 1..{max_group} times Hkv={Hkv}")


def _check(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens) -> None:
    check_pages(q, k_cache, v_cache, k_scale, v_scale, MAX_GROUP)
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and seq_lens [B]")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """out [B, Hq, D]: each row's single query over the live window of its
    ``seq_lens`` cached tokens in bf16 pages (see
    ``csrc/paged_decode_attention.cu``)."""
    native.check_same_device(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, page_table, seq_lens, sm_scale,
            logit_cap=logit_cap, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    cap, window = mask_args(logit_cap, sliding_window)
    _check(q, k_cache, v_cache, None, None, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, k_cache.shape[2], D, page_table.shape[1], k_cache.shape[1],
        float(sm_scale), cap, window, native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(
    q: torch.Tensor,
    k_cache: torch.Tensor,  # int8 | float8_e4m3fn [pages, ps, Hkv, D]
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # bf16 [pages, ps, Hkv]
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """``paged_decode_attention`` over 8-bit pages: the kernel folds the
    scales out of its dots, s = (q . k_code) s_k and p' = p s_v; the cap
    applies to that s."""
    native.check_same_device(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, page_table, seq_lens, sm_scale, k_scale, v_scale,
            logit_cap, sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_quant: unsupported device {q.device}")
    cap, window = mask_args(logit_cap, sliding_window)
    _check(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, k_cache.shape[2], D, page_table.shape[1], k_cache.shape[1],
        CODE_TYPES[k_cache.dtype], float(sm_scale), cap, window,
        native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_quant launch failed: cudaError {rc}")
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention_quant.launches = 0


def decode_attention_gqa(
    q: torch.Tensor,  # [B, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Model-facing decode attention over one layer of the pool (the
    ``attention_backend="auto"`` decode)."""
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    if k_scale is None:
        return paged_decode_attention(
            q, k, v, meta.page_table, meta.seq_lens, sm_scale, logit_cap, sliding_window
        )
    return paged_decode_attention_quant(
        q, k, v, k_scale, v_scale, meta.page_table, meta.seq_lens, sm_scale,
        logit_cap, sliding_window,
    )
