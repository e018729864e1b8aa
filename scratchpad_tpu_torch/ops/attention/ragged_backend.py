"""Paged ragged extend attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``scratchpad_tpu/ops/attention/ragged_backend.py``, which
calls the bundled Pallas ``ragged_paged_attention`` kernel for every prefill
step; here that is the hand-written ``csrc/paged_extend_attention.cu``.
For int8 and fp8 pools the JAX package first dequantizes the batch's pages
into a bf16 scratch pool (``dequant_pages``), because the bundled kernel has
no per-row scales; the port's kernel reads the codes and their (token, head)
scales itself and dequantizes as it stages each K/V tile, so there is no
scratch pool (``paged_extend_attention_quant``).

Semantics (shared by the kernel and ``paged_extend_attention_plain``): the
flat ragged batch ``q [T, Hq, D]`` holds sequence s's ``q_len_s`` new tokens
at ``[cu_q_lens[s], cu_q_lens[s+1])``; its query i attends kv positions
``[0, kv_lens[s] - q_len_s + i]`` (causal, aligned to the tail of the
cache). Tokens past ``cu_q_lens[B]`` are batch padding and come out as
zeros. ``sm_scale`` is applied once, inside.

The bundled kernel's ``soft_cap`` and ``sliding_window`` (``ragged_backend.py
:98-99``) follow ``xla_backend.extend_attention_xla``: the score is ``cap *
tanh(s / cap)``, and the query at position ``p`` attends ``p - W < j <= p``.
The kernel starts each tile's KV loop at the window of its first query and
masks each query row on its own inside it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    CODE_TYPES,
    check_pages,
    gather_kv_rows,
    mask_args,
    softcap,
)
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_extend_attention": (
        [_P] * 9 + [_I] * 8 + [ctypes.c_float, ctypes.c_float, _I, _P],
        ctypes.c_int,
    ),
    "paged_extend_attention_quant": (
        [_P] * 11 + [_I] * 9 + [ctypes.c_float, ctypes.c_float, _I, _P],
        ctypes.c_int,
    ),
    "paged_extend_tokens_per_tile": ([_I], ctypes.c_int),
}
MAX_GROUP = 64  # a tile holds 64 (token, head) rows
QUERY_BLOCK = 1024  # query rows the plain version scores at a time


def paged_extend_attention_plain(
    q: torch.Tensor,  # [T, Hq, D]
    k_cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # i32[B, P]
    kv_lens: torch.Tensor,  # i32[B]
    cu_q_lens: torch.Tensor,  # i32[B + 1]
    sm_scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [pages, ps, Hkv] for 8-bit pages
    v_scale: Optional[torch.Tensor] = None,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """One sequence at a time: gather its live pages (dequantized in f32
    for 8-bit pages), attend in f32 under the tail-aligned causal mask and
    the window, ``QUERY_BLOCK`` queries at a time (a long prompt's score
    tensor would not fit the card otherwise)."""
    mask_args(logit_cap, sliding_window)
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    out = torch.zeros_like(q)
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    for s in range(len(lens)):
        q_len = cu[s + 1] - cu[s]
        if q_len == 0:
            continue
        kv_len = lens[s]
        pos = torch.arange(kv_len, device=q.device)
        slots = page_table[s].long()[pos // ps] * ps + pos % ps
        k = gather_kv_rows(k_cache, k_scale, slots)  # [S, Hkv, D]
        v = gather_kv_rows(v_cache, v_scale, slots)
        for i0 in range(0, q_len, QUERY_BLOCK):
            n = min(QUERY_BLOCK, q_len - i0)
            t0 = cu[s] + i0
            qs = q[t0 : t0 + n].float().reshape(n, Hkv, G, D) * sm_scale
            scores = softcap(torch.einsum("thgd,shd->hgts", qs, k), logit_cap)
            q_pos = kv_len - q_len + i0 + torch.arange(n, device=q.device)
            live = pos[None, :] <= q_pos[:, None]  # [t, S]
            if sliding_window is not None:
                live &= pos[None, :] > q_pos[:, None] - sliding_window
            p = torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)
            o = torch.einsum("hgts,shd->thgd", p, v).reshape(n, Hq, D)
            out[t0 : t0 + n] = o.to(q.dtype)
    return out


def tile_map(
    cu_q_lens: torch.Tensor, num_tokens: int, tokens_per_tile: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The extend kernel's CTA -> sequence map, built on the device without
    a host sync. Sequence s gets ceil(q_len_s / tokens_per_tile) tiles;
    ``tile_cum`` is their inclusive prefix sum and ``tile_seq[i]`` the
    sequence of tile i (B for the tiles that zero the padding tokens). The
    grid ``ceil(T / bq) + B + 1`` bounds every tile the batch can need."""
    B = cu_q_lens.shape[0] - 1
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    tiles = (q_lens + tokens_per_tile - 1) // tokens_per_tile
    tile_cum = torch.cumsum(tiles, 0, dtype=torch.int32)
    n_tiles = -(-num_tokens // tokens_per_tile) + B + 1
    ids = torch.arange(n_tiles, device=cu_q_lens.device, dtype=torch.int32)
    tile_seq = torch.searchsorted(tile_cum, ids, right=True, out_int32=True)
    return tile_seq, tile_cum


def _check(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens) -> None:
    check_pages(q, k_cache, v_cache, k_scale, v_scale, MAX_GROUP)
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens), ("cu_q_lens", cu_q_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    B = kv_lens.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or cu_q_lens.shape != (B + 1,):
        raise ValueError("page_table must be [B, P], kv_lens [B], cu_q_lens [B + 1]")


def _launch(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens, sm_scale,
            logit_cap, sliding_window):
    """Check the inputs, build the tile map and launch the kernel: the bf16
    entry point without scales, the 8-bit one with them."""
    cap, window = mask_args(logit_cap, sliding_window)
    _check(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens)
    lib = native.load("paged_extend_attention", _SIGNATURES)
    T, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    tile_seq, tile_cum = tile_map(cu_q_lens, T, lib.paged_extend_tokens_per_tile(Hq // Hkv))
    out = torch.empty_like(q)
    head = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    tail = (
        page_table.data_ptr(), kv_lens.data_ptr(), cu_q_lens.data_ptr(),
        tile_seq.data_ptr(), tile_cum.data_ptr(), out.data_ptr(),
        tile_seq.shape[0], kv_lens.shape[0], T, Hq, Hkv, D,
        page_table.shape[1], k_cache.shape[1],
    )
    stream = native.stream_handle(q.device)
    if k_scale is None:
        rc = lib.paged_extend_attention(*head, *tail, float(sm_scale), cap, window, stream)
    else:
        rc = lib.paged_extend_attention_quant(
            *head, k_scale.data_ptr(), v_scale.data_ptr(), *tail,
            CODE_TYPES[k_cache.dtype], float(sm_scale), cap, window, stream,
        )
    if rc != 0:
        kind = "bf16" if k_scale is None else str(k_cache.dtype)
        raise RuntimeError(f"paged extend attention ({kind} pages) launch failed: cudaError {rc}")
    return out


def paged_extend_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    cu_q_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """out [T, Hq, D] for the flat ragged batch over bf16 pages (see the
    module docstring and ``csrc/paged_extend_attention.cu``)."""
    native.check_same_device(q, k_cache, v_cache, page_table, kv_lens, cu_q_lens)
    if q.device.type == "cpu":
        return paged_extend_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, cu_q_lens, sm_scale,
            logit_cap=logit_cap, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_extend_attention: unsupported device {q.device}")
    out = _launch(
        q, k_cache, v_cache, None, None, page_table, kv_lens, cu_q_lens, sm_scale,
        logit_cap, sliding_window,
    )
    paged_extend_attention.launches += 1
    return out


paged_extend_attention.launches = 0


def paged_extend_attention_quant(
    q: torch.Tensor,
    k_cache: torch.Tensor,  # int8 | float8_e4m3fn [pages, ps, Hkv, D]
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # bf16 [pages, ps, Hkv]
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    cu_q_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """``paged_extend_attention`` over 8-bit pages: the kernel dequantizes
    each K/V element with its (token, head) scale as it stages the tile."""
    native.check_same_device(
        q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens
    )
    if q.device.type == "cpu":
        return paged_extend_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, cu_q_lens, sm_scale, k_scale, v_scale,
            logit_cap, sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_extend_attention_quant: unsupported device {q.device}")
    out = _launch(
        q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens, sm_scale,
        logit_cap, sliding_window,
    )
    paged_extend_attention_quant.launches += 1
    return out


paged_extend_attention_quant.launches = 0


def attention_ragged(
    q: torch.Tensor,  # [T, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Model-facing extend attention over one layer of the pool."""
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    if k_scale is None:
        return paged_extend_attention(
            q, k, v, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale,
            logit_cap, sliding_window,
        )
    return paged_extend_attention_quant(
        q, k, v, k_scale, v_scale, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale,
        logit_cap, sliding_window,
    )
