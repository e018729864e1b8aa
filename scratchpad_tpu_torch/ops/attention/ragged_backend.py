"""Paged ragged extend attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``scratchpad_tpu/ops/attention/ragged_backend.py``, which
calls the bundled Pallas ``ragged_paged_attention`` kernel for every prefill
step; here that is the hand-written ``csrc/paged_extend_attention.cu``.

Semantics (shared by the kernel and ``paged_extend_attention_plain``): the
flat ragged batch ``q [T, Hq, D]`` holds sequence s's ``q_len_s`` new tokens
at ``[cu_q_lens[s], cu_q_lens[s+1])``; its query i attends kv positions
``[0, kv_lens[s] - q_len_s + i]`` (causal, aligned to the tail of the
cache). Tokens past ``cu_q_lens[B]`` are batch padding and come out as
zeros. ``sm_scale`` is applied once, inside.
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
    "paged_extend_attention": (
        [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "paged_extend_tokens_per_tile": ([_I], ctypes.c_int),
}
HEAD_DIMS = (32, 64, 128)


def paged_extend_attention_plain(
    q: torch.Tensor,  # [T, Hq, D]
    k_cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # i32[B, P]
    kv_lens: torch.Tensor,  # i32[B]
    cu_q_lens: torch.Tensor,  # i32[B + 1]
    sm_scale: float,
) -> torch.Tensor:
    """One sequence at a time: gather its live pages, attend in f32 under
    the tail-aligned causal mask."""
    T, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    out = torch.zeros_like(q)
    k_rows = k_cache.reshape(-1, Hkv, D)
    v_rows = v_cache.reshape(-1, Hkv, D)
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    for s in range(len(lens)):
        q_len = cu[s + 1] - cu[s]
        if q_len == 0:
            continue
        kv_len = lens[s]
        pos = torch.arange(kv_len, device=q.device)
        slots = page_table[s].long()[pos // ps] * ps + pos % ps
        k = k_rows[slots].float()  # [S, Hkv, D]
        v = v_rows[slots].float()
        qs = q[cu[s] : cu[s + 1]].float().reshape(q_len, Hkv, G, D) * sm_scale
        scores = torch.einsum("thgd,shd->hgts", qs, k)
        q_pos = kv_len - q_len + torch.arange(q_len, device=q.device)
        causal = pos[None, :] <= q_pos[:, None]  # [t, S]
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hgts,shd->thgd", p, v).reshape(q_len, Hq, D)
        out[cu[s] : cu[s + 1]] = o.to(q.dtype)
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


def _check(q, k_cache, v_cache, page_table, kv_lens, cu_q_lens) -> None:
    tensors = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("page_table", page_table), ("kv_lens", kv_lens),
               ("cu_q_lens", cu_q_lens))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors[:3]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the extend kernel takes bf16 {name}, got {t.dtype}")
    for name, t in tensors[3:]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    T, Hq, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[3] != D:
        raise ValueError(f"k/v caches must be [pages, ps, Hkv, {D}], got {tuple(k_cache.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % k_cache.shape[2]:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={k_cache.shape[2]}")
    B = kv_lens.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or cu_q_lens.shape != (B + 1,):
        raise ValueError("page_table must be [B, P], kv_lens [B], cu_q_lens [B + 1]")


def paged_extend_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    cu_q_lens: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """out [T, Hq, D] for the flat ragged batch (see the module docstring
    and ``csrc/paged_extend_attention.cu``)."""
    native.check_same_device(q, k_cache, v_cache, page_table, kv_lens, cu_q_lens)
    if q.device.type == "cpu":
        return paged_extend_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, cu_q_lens, sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_extend_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, page_table, kv_lens, cu_q_lens)
    lib = native.load("paged_extend_attention", _SIGNATURES)
    T, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    bq = lib.paged_extend_tokens_per_tile(Hq // Hkv)
    if bq <= 0:
        raise ValueError(f"group size {Hq // Hkv} too large for the extend kernel")
    tile_seq, tile_cum = tile_map(cu_q_lens, T, bq)
    out = torch.empty_like(q)
    rc = lib.paged_extend_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), cu_q_lens.data_ptr(),
        tile_seq.data_ptr(), tile_cum.data_ptr(), out.data_ptr(),
        tile_seq.shape[0], kv_lens.shape[0], T, Hq, Hkv, D,
        page_table.shape[1], k_cache.shape[1], float(sm_scale),
        native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged_extend_attention launch failed: cudaError {rc}")
    paged_extend_attention.launches += 1
    return out


paged_extend_attention.launches = 0


def attention_ragged(
    q: torch.Tensor,  # [T, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Model-facing extend attention over one layer of the pool."""
    k, v = kv.layer(layer_idx)
    return paged_extend_attention(
        q, k, v, meta.page_table, meta.seq_lens, meta.cu_q_lens, sm_scale
    )
