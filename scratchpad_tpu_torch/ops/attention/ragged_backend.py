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
masks each query row on its own inside it. Both are runtime arguments of
each call, so Gemma's layers each pass their own window (the JAX package
runs Gemma's extend in XLA at head_dim 256, ``executor/model_runner.py:185``,
and the ragged kernel under ``lax.cond`` at 128, ``make_window_cond_extend``).
bf16 and 8-bit pages take head_dim 32, 64, 128 and 256 (at 256 the 8-bit
kernel converts the codes from registers: no code ring fits beside its
bf16 stages).

``chunk_size`` (None or C >= 1, Llama-4's rope layers) follows
``xla_backend.extend_attention_xla:479-483``: the query at position ``p``
attends the keys of its own chunk, ``p // C * C <= j <= p``. The JAX
package extends Llama-4 in XLA (``models/llama4.py:48``), so this branch is
the port's own. The kernel starts each tile's KV loop at its first query's
chunk, and a tile that straddles a chunk edge masks each row by its own.

``sinks`` (f32 ``[Hq]`` or None, GPT-OSS) follows
``xla_backend.extend_attention_xla:508-515``: each query head's sink logit
joins every one of its rows' softmax and carries no value. The JAX package
extends GPT-OSS in XLA (``models/gpt_oss.py:54``); the port keeps its plain
path off the card, so the extend kernel takes the sinks.

``mm_spans`` (i32 ``[B, M, 2]`` or None, Gemma 3 multimodal; rows 3m and
3qm) follows ``xla_backend.extend_attention_xla:484-507``: absolute ``[s0,
s1)`` ranges, ``(0, 0)`` for none; a query at ``p`` inside a span also
attends every key ``j < kv_len`` of that span, both ways, whatever the
causal rule or the window say. The JAX package extends Gemma 3 multimodal
in XLA (``models/gemma.py:326``); the port's Gemma extends through the
kernel, which widens each row's bounds to its span and each tile's KV loop
to the spans of its queries. Spans with a chunk are refused.
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
    check_rank_heads,
    gather_kv_rows,
    mask_args,
    sinks_arg,
    softcap,
    softmax_with_sinks,
)
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_extend_attention": (
        [_P] * 9 + [_I] * 8 + [ctypes.c_float, ctypes.c_float, _I, _I, _P, _P, _I, _P],
        ctypes.c_int,
    ),
    "paged_extend_attention_quant": (
        [_P] * 11 + [_I] * 9 + [ctypes.c_float, ctypes.c_float, _I, _I, _P, _P, _I, _P],
        ctypes.c_int,
    ),
    "paged_extend_tokens_per_tile": ([_I, _I], ctypes.c_int),
}
MAX_GROUP = 64  # a tile holds 64 or 128 (token, head) rows
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
    sinks: Optional[torch.Tensor] = None,  # f32 [Hq]
    chunk_size: Optional[int] = None,
    mm_spans: Optional[torch.Tensor] = None,  # i32 [B, M, 2]
) -> torch.Tensor:
    """One sequence at a time: gather its live pages (dequantized in f32
    for 8-bit pages), attend in f32 under the tail-aligned causal mask, the
    window or the chunk, the spans and the sinks, ``QUERY_BLOCK`` queries at
    a time (a long prompt's score tensor would not fit the card otherwise)."""
    _, sliding_window, chunk_size = (a or None for a in mask_args(logit_cap, sliding_window, chunk_size))
    span_args(mm_spans, chunk_size, kv_lens)
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
            if chunk_size is not None:
                live &= pos[None, :] >= q_pos[:, None] // chunk_size * chunk_size
            if mm_spans is not None:  # the same span, both ways (pos < kv_len)
                s0, s1 = mm_spans[s, :, 0].long(), mm_spans[s, :, 1].long()
                q_in = (q_pos[:, None] >= s0) & (q_pos[:, None] < s1)  # [t, M]
                kv_in = (pos[None, :] >= s0[:, None]) & (pos[None, :] < s1[:, None])  # [M, S]
                live |= (q_in[:, :, None] & kv_in[None]).any(dim=1)
            p = softmax_with_sinks(scores.masked_fill(~live, float("-inf")), sinks, (Hkv, G, 1, 1))
            o = torch.einsum("hgts,shd->thgd", p, v).reshape(n, Hq, D)
            out[t0 : t0 + n] = o.to(q.dtype)
    return out


def span_args(mm_spans: Optional[torch.Tensor], chunk_size: Optional[int],
              kv_lens: torch.Tensor) -> tuple[int, int]:
    """The kernel's pointer to ``mm_spans`` and its spans a sequence (0, 0
    for none): contiguous i32 ``[B, M, 2]`` on the batch's device, M >= 1,
    never with a chunk (no model makes the pair)."""
    if mm_spans is None:
        return 0, 0
    if chunk_size:
        raise ValueError(f"bidirectional spans and a chunk ({chunk_size}) in one call")
    B = kv_lens.shape[0]
    if (mm_spans.dtype != torch.int32 or mm_spans.dim() != 3 or mm_spans.shape[0] != B
            or mm_spans.shape[2] != 2 or mm_spans.shape[1] < 1 or not mm_spans.is_contiguous()):
        raise ValueError(
            f"mm_spans must be contiguous int32 [{B}, M, 2], got {mm_spans.dtype} "
            f"{tuple(mm_spans.shape)}"
        )
    native.check_same_device(kv_lens, mm_spans)
    return mm_spans.data_ptr(), mm_spans.shape[1]


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
            logit_cap, sliding_window, sinks, chunk_size, mm_spans):
    """Check the inputs, build the tile map and launch the kernel: the bf16
    entry point without scales, the 8-bit one with them."""
    masks = mask_args(logit_cap, sliding_window, chunk_size)
    _check(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens)
    sinks_ptr = sinks_arg(sinks, q)
    spans = span_args(mm_spans, masks[2], kv_lens)
    lib = native.load("paged_extend_attention", _SIGNATURES)
    T, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    tile_seq, tile_cum = tile_map(cu_q_lens, T, lib.paged_extend_tokens_per_tile(Hq // Hkv, D))
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
        rc = lib.paged_extend_attention(*head, *tail, float(sm_scale), *masks, sinks_ptr, *spans, stream)
    else:
        rc = lib.paged_extend_attention_quant(
            *head, k_scale.data_ptr(), v_scale.data_ptr(), *tail,
            CODE_TYPES[k_cache.dtype], float(sm_scale), *masks, sinks_ptr, *spans, stream,
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
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
    mm_spans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out [T, Hq, D] for the flat ragged batch over bf16 pages (see the
    module docstring and ``csrc/paged_extend_attention.cu``)."""
    native.check_same_device(q, k_cache, v_cache, page_table, kv_lens, cu_q_lens)
    if q.device.type == "cpu":
        return paged_extend_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, cu_q_lens, sm_scale,
            logit_cap=logit_cap, sliding_window=sliding_window, sinks=sinks, chunk_size=chunk_size,
            mm_spans=mm_spans,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_extend_attention: unsupported device {q.device}")
    out = _launch(
        q, k_cache, v_cache, None, None, page_table, kv_lens, cu_q_lens, sm_scale,
        logit_cap, sliding_window, sinks, chunk_size, mm_spans,
    )
    paged_extend_attention.launches += 1
    paged_extend_attention.span_launches += mm_spans is not None
    return out


paged_extend_attention.launches = 0
paged_extend_attention.span_launches = 0  # the launches with spans (row 3m)


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
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
    mm_spans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``paged_extend_attention`` over 8-bit pages: the kernel dequantizes
    each K/V element with its (token, head) scale as it stages the tile."""
    native.check_same_device(
        q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens
    )
    if q.device.type == "cpu":
        return paged_extend_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, cu_q_lens, sm_scale, k_scale, v_scale,
            logit_cap, sliding_window, sinks, chunk_size, mm_spans,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_extend_attention_quant: unsupported device {q.device}")
    out = _launch(
        q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens, cu_q_lens, sm_scale,
        logit_cap, sliding_window, sinks, chunk_size, mm_spans,
    )
    paged_extend_attention_quant.launches += 1
    paged_extend_attention_quant.span_launches += mm_spans is not None
    return out


paged_extend_attention_quant.launches = 0
paged_extend_attention_quant.span_launches = 0  # the launches with spans (row 3qm)


def attention_ragged(
    q: torch.Tensor,  # [T, Hq, D]
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
    """Model-facing extend attention over one layer of the pool; the
    batch's bidirectional spans (``meta.mm_spans``, Gemma 3 multimodal) go
    to the kernel with it."""
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    if k_scale is None:
        return paged_extend_attention(
            q, k, v, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale,
            logit_cap, sliding_window, sinks, chunk_size, meta.mm_spans,
        )
    return paged_extend_attention_quant(
        q, k, v, k_scale, v_scale, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale,
        logit_cap, sliding_window, sinks, chunk_size, meta.mm_spans,
    )


def make_attention_ragged_tp(group, heads: tuple[int, int]):
    """Extend on a tensor-parallel rank, the counterpart of the JAX
    ``make_attention_ragged_tp`` (``ragged_backend.py:513``): each rank runs
    the unmodified kernel (row 3, or 3q on 8-bit pages) over its local heads,
    with no collective. ``heads``: the model's (Hq, Hkv)."""

    def attention_ragged_tp(q, kv: KVCache, layer_idx: int, meta: ForwardMeta, **kw):
        check_rank_heads(q, kv, heads, group, "attention_ragged_tp")
        return attention_ragged(q, kv, layer_idx, meta, **kw)

    return attention_ragged_tp
