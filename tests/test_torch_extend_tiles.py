"""The extend kernel's tiling and arithmetic, on the CPU.

- ``ragged_backend.tile_map``, the CTA -> sequence map the kernel is
  launched with, for 64 // G and 128 // G query tokens a tile: every real
  token lies in exactly one tile of its own sequence, the padding tiles
  cover ``[cu_q_lens[B], T)``, and the grid ``ceil(T / bq) + B + 1`` holds
  every tile the batch needs. The tile -> tokens rule is the kernel's own
  (``csrc/paged_extend_attention.cu``, the prologue of
  ``paged_extend_kernel``).
- A plain emulation of the kernel's arithmetic (64-token KV blocks, an f32
  online softmax in log2 units, P split into bf16 hi + lo, and on 8-bit
  pages a third bf16 term, the K scale on the score columns, the V scale
  folded into P, the output rounded to bf16)
  against the JAX package's references, ``extend_attention_xla`` and the
  bundled kernel's ``ref_ragged_paged_attention``, over bf16, int8 and fp8
  pages (8-bit: the references read the pages dequantized in f32), with and
  without (cap, W) = (30, 1000), at the card's gate |emu - ref| <= 1e-4 +
  2**-8 |ref|. The same emulation with P rounded to bf16 once exceeds that
  gate, which is why the kernel splits P.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.ragged_paged_attention import ref_ragged_paged_attention

from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.ops.attention.xla_backend import extend_attention_xla
from scratchpad_tpu_torch.ops.attention import quantize_rows
from scratchpad_tpu_torch.ops.attention.ragged_backend import tile_map
from test_torch_attention import LAYER, _extend_inputs, _pools
import torch_threads  # noqa: F401  (one torch thread a test process)

ATOL, RTOL = 1e-4, 2.0**-8  # chip_smoke.py's kernel-vs-plain gate
LOG2E = 1.4426950408889634
KV_BLOCK = 64
CODES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


# ------------------------------------------------------------- tile map


def _tile_tokens(tile, tile_seq, tile_cum, cu, bq, T):
    """The tokens tile ``tile`` writes, by the kernel's rule, and whether it
    is a padding tile."""
    B = len(cu) - 1
    s = tile_seq[tile]
    if s >= B:
        first_pad_tile = tile_cum[B - 1] if B > 0 else 0
        t0 = cu[B] + (tile - first_pad_tile) * bq
        return range(t0, min(t0 + bq, T)), True
    q_len = cu[s + 1] - cu[s]
    tiles_s = -(-q_len // bq)
    i0 = (tile - (tile_cum[s] - tiles_s)) * bq
    return range(cu[s] + i0, cu[s] + min(i0 + bq, q_len)), False


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize(
    "q_lens, T",
    [
        ([100, 0, 37, 1, 250], 400),  # a 0-length sequence, padding tokens
        ([0, 0, 5], 5),  # leading empty sequences, no padding
        ([128, 64, 21], 213),  # lengths on tile edges
        ([300], 333),
    ],
)
def test_tile_map_covers_each_token_once(rows, G, q_lens, T):
    bq = rows // G
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    tile_seq, tile_cum = tile_map(torch.from_numpy(cu), T, bq)
    tile_seq, tile_cum = tile_seq.tolist(), tile_cum.tolist()
    B = len(q_lens)
    needed = sum(-(-n // bq) for n in q_lens) + -(-(T - int(cu[-1])) // bq)
    assert len(tile_seq) == -(-T // bq) + B + 1 >= needed
    seq_of = np.searchsorted(cu, np.arange(T), side="right") - 1
    hits = np.zeros(T, np.int64)
    for tile in range(len(tile_seq)):
        toks, pad = _tile_tokens(tile, tile_seq, tile_cum, cu.tolist(), bq, T)
        assert len(toks) <= bq
        for t in toks:
            hits[t] += 1
            if pad:
                assert t >= cu[-1]
            else:
                assert seq_of[t] == tile_seq[tile]  # a tile of the token's own sequence
    assert np.all(hits[: cu[-1]] == 1)  # each real token once
    assert np.all(hits[cu[-1] :] >= 1)  # the padding covered


# -------------------------------------------------- the kernel's arithmetic


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_extend(q, k, v, ks, vs, kv_len, q_len, G, sm_scale, cap, window, terms=None):
    """One sequence as the kernel computes it: q [q_len, Hq, D] of bf16
    values, k / v [kv_len, Hkv, D] of bf16 values (8-bit pages: the codes,
    exact in bf16) with scales ks / vs [kv_len, Hkv] (None for bf16 pages).
    P goes to PV in ``terms`` bf16 terms: the kernel's 2 (hi + lo) over bf16
    pages, 3 over 8-bit pages. Returns bf16 values in f32."""
    terms = terms or (2 if vs is None else 3)
    Hq, D = q.shape[1], q.shape[2]
    Hkv = Hq // G
    pos = kv_len - q_len + torch.arange(q_len)  # each query's position
    lo = pos - window + 1 if window else torch.zeros_like(pos)
    qh = q.reshape(q_len, Hkv, G, D).permute(1, 2, 0, 3).reshape(Hkv, G * q_len, D)
    lim_r = pos.repeat(G)
    lo_r = lo.repeat(G)
    rows = G * q_len
    m = torch.full((Hkv, rows), -torch.inf)
    l = torch.zeros(Hkv, rows)
    o = torch.zeros(Hkv, rows, D)
    mul = 1.0 if cap else sm_scale * LOG2E
    for k0 in range(0, kv_len, KV_BLOCK):
        j = torch.arange(k0, min(k0 + KV_BLOCK, kv_len))
        kb = k[j].permute(1, 2, 0)  # [Hkv, D, n]
        s = torch.bmm(qh, kb)  # bf16 products, f32 sums
        if ks is not None:
            s = s * ks[j].T[:, None, :]
        if cap:
            s = (cap * LOG2E) * torch.tanh(s * (sm_scale / cap))
        dead = (j[None, :] > lim_r[:, None]) | (j[None, :] < lo_r[:, None])
        s = s.masked_fill(dead, -torch.inf)
        m_new = torch.maximum(m, s.max(-1).values * mul)
        mu = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * mul - mu[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        if vs is not None:
            p = p * vs[j].T[:, None, :]
        vb = v[j].permute(1, 0, 2)  # [Hkv, n, D]
        pv = torch.zeros_like(o)
        for _ in range(terms):  # P as a sum of bf16 terms, each its own product
            part = _bf16(p)
            pv = pv + torch.bmm(part, vb)
            p = p - part
        o = o * alpha[..., None] + pv
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    out = _bf16(o * inv[..., None])  # [Hkv, G * q_len, D]
    return out.reshape(Hkv, G, q_len, D).permute(2, 0, 1, 3).reshape(q_len, Hq, D)


def _pages(kind, k, v):
    """bf16-valued K/V and their dequantized f32 (bf16 pages), or 8-bit
    codes (as f32) with bf16 scales (as f32) and the dequantized pages."""
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        kb, vb = _bf16(kt), _bf16(vt)
        return kb, vb, None, None, kb, vb
    kc, ks = quantize_rows(kt, CODES[kind])
    vc, vs = quantize_rows(vt * 0.05, CODES[kind])  # V on another scale than K
    kc, vc, ks, vs = kc.float(), vc.float(), ks.float(), vs.float()
    return kc, vc, ks, vs, kc * ks[..., None], vc * vs[..., None]


def _references(chunks, Hq, Hkv, D, ps, num_pages, pt, loc, kd, vd, q, kv_lens, q_lens, cu,
                scale, cap, window):
    """extend_attention_xla and ref_ragged_paged_attention on the pages
    ``kd`` / ``vd`` (f32, by token slot), real tokens only."""
    T, n_real, B = q.shape[0], int(cu[-1]), len(chunks)
    req = np.full(T, B - 1, np.int32)
    pos = np.zeros(T, np.int32)
    for s, (ql, kl) in enumerate(chunks):
        req[cu[s] : cu[s + 1]] = s
        pos[cu[s] : cu[s + 1]] = np.arange(kl - ql, kl)
    jm = JaxMeta(
        mode=JaxMode.EXTEND, tokens=jnp.zeros(T, jnp.int32), positions=jnp.asarray(pos),
        out_cache_loc=jnp.zeros(T, jnp.int32), req_indices=jnp.asarray(req),
        page_table=jnp.asarray(pt), seq_lens=jnp.asarray(kv_lens),
        extend_lens=jnp.asarray(q_lens), last_token_idx=jnp.asarray(cu[1:] - 1),
    )
    jkv, _ = _pools(num_pages, ps, Hkv, D, loc, kd.numpy(), vd.numpy(), D)
    qj = jnp.asarray(q)
    xla = np.asarray(extend_attention_xla(
        qj, jkv, LAYER, jm, page_size=ps, sm_scale=scale, logit_cap=cap, sliding_window=window
    ))[:n_real]
    bundled = np.asarray(ref_ragged_paged_attention(
        qj, jkv.kv, jnp.asarray(kv_lens), jnp.asarray(pt + LAYER * num_pages), jnp.asarray(cu),
        jnp.asarray([B], jnp.int32), sm_scale=scale, sliding_window=window, soft_cap=cap,
    ))[:n_real]
    return xla, bundled


def _emulate_batch(chunks, q, kc, vc, ks, vs, rows_of, G, scale, cap, window, terms=None):
    out = []
    t0 = 0
    for s, (ql, kl) in enumerate(chunks):
        if ql:
            rows = rows_of[s]
            out.append(emulate_extend(
                q[t0 : t0 + ql], kc[rows], vc[rows], None if ks is None else ks[rows],
                None if vs is None else vs[rows], kl, ql, G, scale, cap, window, terms,
            ))
        t0 += ql
    return torch.cat(out).numpy()


def _ratio(out, ref) -> float:
    """The largest |out - ref| over its gate (<= 1 passes)."""
    return float(np.max(np.abs(out - ref) / (ATOL + RTOL * np.abs(ref))))


def _case(chunks, Hq, Hkv, D, ps, T_pad, seed, kind, cap):
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed
    )
    if cap:
        q = q * 8.0  # scores that reach the cap (chip_smoke.py's CAP_Q_SCALE)
    q = _bf16(torch.from_numpy(q)).numpy()
    kc, vc, ks, vs, kd, vd = _pages(kind, k, v)
    # each sequence's rows of k and v (its cached tokens, in order)
    starts = np.concatenate([[0], np.cumsum(kv_lens)])
    rows_of = [torch.arange(starts[s], starts[s + 1]) for s in range(len(chunks))]
    return num_pages, pt, loc, q, kv_lens, q_lens, cu, kc, vc, ks, vs, kd, vd, rows_of


EMU_CHUNKS = [(200, 1400), (130, 130), (1, 1050), (0, 0), (70, 1001)]


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("cap, window", [(None, None), (30.0, 1000)])
def test_kernel_arithmetic_meets_the_gate(kind, cap, window):
    Hq, Hkv, D, ps, G = 8, 2, 64, 16, 4
    (num_pages, pt, loc, q, kv_lens, q_lens, cu, kc, vc, ks, vs, kd, vd,
     rows_of) = _case(EMU_CHUNKS, Hq, Hkv, D, ps, 420, 17, kind, cap)
    scale = 1.0 / np.sqrt(D)
    xla, bundled = _references(EMU_CHUNKS, Hq, Hkv, D, ps, num_pages, pt, loc, kd, vd, q,
                               kv_lens, q_lens, cu, scale, cap, window)
    emu = _emulate_batch(EMU_CHUNKS, torch.from_numpy(q), kc, vc, ks, vs, rows_of, G, scale,
                         cap, window)
    assert _ratio(emu, xla) <= 1.0
    assert _ratio(emu, bundled) <= 1.0


def test_one_bf16_rounding_of_p_exceeds_the_gate():
    """256 queries on 1,000 cached tokens, G 3, D 64: P rounded once to bf16
    misses the gate that P as bf16 hi + lo meets."""
    chunks = [(256, 1000)]
    Hq, Hkv, D, ps, G = 6, 2, 64, 16, 3
    (num_pages, pt, loc, q, kv_lens, q_lens, cu, kc, vc, ks, vs, kd, vd,
     rows_of) = _case(chunks, Hq, Hkv, D, ps, 256, 5, "bf16", None)
    scale = 1.0 / np.sqrt(D)
    xla, _ = _references(chunks, Hq, Hkv, D, ps, num_pages, pt, loc, kd, vd, q, kv_lens,
                         q_lens, cu, scale, None, None)
    qt = torch.from_numpy(q)
    split = _emulate_batch(chunks, qt, kc, vc, ks, vs, rows_of, G, scale, None, None)
    single = _emulate_batch(chunks, qt, kc, vc, ks, vs, rows_of, G, scale, None, None, terms=1)
    assert _ratio(split, xla) <= 1.0 < _ratio(single, xla)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_a_third_term_of_p_nears_f32(kind):
    """P in three bf16 terms (the kernel's on 8-bit pages) leaves far fewer
    outputs off the f32 reference's bf16 rounding than two: 0.034 % against
    0.22 % at this case, on either page kind."""
    Hq, Hkv, D, ps, G = 8, 2, 64, 16, 4
    (num_pages, pt, loc, q, kv_lens, q_lens, cu, kc, vc, ks, vs, kd, vd,
     rows_of) = _case(EMU_CHUNKS, Hq, Hkv, D, ps, 420, 17, kind, None)
    scale = 1.0 / np.sqrt(D)
    xla, _ = _references(EMU_CHUNKS, Hq, Hkv, D, ps, num_pages, pt, loc, kd, vd, q, kv_lens,
                         q_lens, cu, scale, None, None)
    ref = _bf16(torch.from_numpy(xla.copy())).numpy()
    qt = torch.from_numpy(q)
    off = {
        terms: float(np.mean(_emulate_batch(EMU_CHUNKS, qt, kc, vc, ks, vs, rows_of, G, scale,
                                            None, None, terms) != ref))
        for terms in (2, 3)
    }
    assert off[3] < off[2] / 4 and off[3] < 1e-3
