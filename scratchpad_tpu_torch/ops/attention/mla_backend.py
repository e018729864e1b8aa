"""Multi-head latent attention (MLA) over the paged latent pool.

Counterpart of ``scratchpad_tpu/ops/attention/mla_backend.py``. The pool
holds one vector a token and layer, ``[c_kv (r) | k_rope (dr)]``
(``memory/kv_cache.py``, ``mla``), and attention runs in the latent space by
absorbing W_UK into the query:

    score(t, s) = q_nope_t . (W_UK c_s) + q_rope_t . k_rope_s
                = (W_UK^T q_nope_t) . c_s + q_rope_t . k_rope_s

so the model hands in ``q_lat = W_UK^T q_nope`` [T, Hq, r] and ``q_rope``
[T, Hq, dr], and gets back the weighted latent ``sum_s p(t, s) c_s`` [T,
Hq, r], which it expands with W_UV (``models/deepseek.py``). Every query
head reads the one latent stream.

The JAX package runs this in XLA, with no Pallas kernel behind it, so the
port runs it in plain PyTorch (``ROADMAP.md``: torch covers the work XLA
covered): the scores and the softmax in f32, as ``mla_attention_xla``
computes them. Decode reads each row's pages through the page table with no
host sync, so decode windows, pipelined ones included, take it as they take
the other models' attention. It gathers every row's page-table width of
latent rows (the gather and its f32 copy, 6 bytes an element at bf16) and
f32 scores: rows go in blocks that keep that under ``DECODE_GATHER_BYTES``,
a workspace that the KV pool's sizing does not count. Extend attends one sequence at a time,
``QUERY_BLOCK`` queries at a time (a long prompt's [Hq, T, S] scores would
not fit the card whole); its sequence bounds come to the host once a forward
(``extend_spans``).
"""

from __future__ import annotations

from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache

_NEG = -1e30
QUERY_BLOCK = 1024  # queries scored at a time in extend
DECODE_GATHER_BYTES = 1 << 30  # decode's gathered latent rows and scores at a time


def write_latent(kv: KVCache, lat: torch.Tensor, layer_idx: int, loc: torch.Tensor) -> None:
    """Write the new latent rows ``lat`` [T, r + dr] of layer ``layer_idx`` at
    the flat slots ``loc`` [T], in place."""
    rows = kv.k[layer_idx].view(-1, kv.k.shape[-1])
    rows.index_copy_(0, loc, lat.to(rows.dtype))


def latent_rows(kv: KVCache, layer_idx: int, pages: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` latent rows [n, r + dr] of one sequence whose pages
    are ``pages`` (one row of the page table)."""
    ps = kv.page_size
    pos = torch.arange(n, device=pages.device)
    slots = pages.long()[pos // ps] * ps + pos % ps
    return kv.k[layer_idx].view(-1, kv.k.shape[-1])[slots]


def extend_spans(meta: ForwardMeta) -> list[tuple[int, int, int]]:
    """Each sequence's (first token, end token, cached tokens incl. the new
    ones) of an extend batch, on the host: one device-to-host copy."""
    both = torch.cat([meta.cu_q_lens.to(torch.int64), meta.seq_lens.to(torch.int64)]).tolist()
    B = meta.batch_size
    return [(both[s], both[s + 1], both[B + 1 + s]) for s in range(B)]


def mla_attention(
    q_lat: torch.Tensor,  # [T, Hq, r] (the nope part absorbed through W_UK)
    q_rope: torch.Tensor,  # [T, Hq, dr]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    spans: Optional[list[tuple[int, int, int]]] = None,
) -> torch.Tensor:
    """The weighted latent [T, Hq, r] in q_lat's dtype, for extend and
    decode: the f32 scores of ``mla_attention_xla`` (JAX
    ``mla_backend.py:53-102``), each query at position p attending the
    cached positions ``j <= p`` of its sequence. ``spans``: the extend
    batch's ``extend_spans`` (computed here when None). Decode rows with
    ``seq_lens == 0`` (padding) and extend tokens past the last sequence
    come out as zeros, as the attention kernels' padding rows do."""
    T, Hq, r = q_lat.shape
    D = kv.k.shape[-1]
    if meta.mode == ForwardMode.DECODE:
        B, P = meta.page_table.shape
        S = P * kv.page_size
        step = max(1, DECODE_GATHER_BYTES // (S * (D * (kv.k.element_size() + 4) + Hq * 12)))
        blocks = [
            _decode_block(q_lat[b : b + step], q_rope[b : b + step], kv, layer_idx,
                          meta.page_table[b : b + step], meta.seq_lens[b : b + step], sm_scale)
            for b in range(0, B, step)
        ]
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    if spans is None:
        spans = extend_spans(meta)
    out = torch.zeros_like(q_lat)
    for s, (a, b, n) in enumerate(spans):
        if a == b:
            continue
        lat = latent_rows(kv, layer_idx, meta.page_table[s], n).float()
        ckv, krope = lat[:, :r], lat[:, r:]
        pos = torch.arange(n, device=lat.device)
        for t0 in range(a, b, QUERY_BLOCK):
            t1 = min(t0 + QUERY_BLOCK, b)
            scores = torch.einsum("thr,sr->hts", q_lat[t0:t1].float(), ckv) + torch.einsum(
                "thd,sd->hts", q_rope[t0:t1].float(), krope
            )
            live = pos[None, :] <= meta.positions[t0:t1, None]  # causal, over the prefix too
            scores = torch.where(live[None], scores * sm_scale, _NEG)
            p = torch.softmax(scores, dim=-1)
            out[t0:t1] = torch.einsum("hts,sr->thr", p, ckv).to(out.dtype)
    return out


def _decode_block(q_lat, q_rope, kv, layer_idx, page_table, seq_lens, sm_scale):
    """Decode attention of the rows of one block: each row's one query over
    its page table's latent rows, the positions past ``seq_lens`` masked."""
    B, P = page_table.shape
    r = q_lat.shape[-1]
    lat = kv.k[layer_idx][page_table.long()].view(B, P * kv.page_size, kv.k.shape[-1]).float()
    ckv, krope = lat[..., :r], lat[..., r:]
    scores = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv) + torch.einsum(
        "bhd,bsd->bhs", q_rope.float(), krope
    )
    live = torch.arange(lat.shape[1], device=lat.device)[None, :] < seq_lens[:, None]
    scores = torch.where(live[:, None, :], scores * sm_scale, _NEG)
    p = torch.softmax(scores, dim=-1) * (seq_lens > 0)[:, None, None]  # padding rows: zeros
    return torch.einsum("bhs,bsr->bhr", p, ckv).to(q_lat.dtype)
