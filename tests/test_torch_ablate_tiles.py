"""The decode ablation probe's kernel arithmetic, emulated on the CPU.

``csrc/decode_ablate.cu`` computes ``decode_ablate_plain``'s function in its
own order. This file repeats that order in torch f32, CTA by CTA (one a row
and kv head), and holds it to the plain version under the card's gates
(``chip_smoke.py``'s ``check_decode_ablate``): ``out`` within one bf16 ulp,
``aux``'s m bit for bit, l and the checksum within ``aux_tolerance``.

- Scores: lane l of a warp sums its Dp / 32 products in turn (the first
  product, then fused adds of exact products); then the transposed head
  tree: at level i lane L pairs with L ^ (16 >> i), and over the first
  log2 NG levels (NG, the heads rounded up to a power of two) a lane keeps
  its heads' upper half where that bit is set and receives the rest from
  its partner; a plain butterfly finishes. Lane L ends with head
  L >> (5 - log2 NG). The scores must equal ``lane_dot``'s bit for bit.
- Chunk statistics, one warp a head: lane l takes rows l, l + 32, ...;
  the masked max, then p = exp(s - m'), its sum in the lane and the lanes'
  halves-first tree; l = psum + l alpha, acc00 = k00 + acc00 alpha, each
  product rounded first.
- PV, four warps over the head dims: the accumulators scaled by alpha when
  the chunk's statistics are taken, then per V page and 16-row step one
  product V^T [Dp x 16] . bf16(p)^T [16 x heads] added in f32 (pad rows of
  a page shorter than a step carry p = 0). The checksum: each lane's dims
  (g and g + 8 of each 16-dim tile) in turn, then the lanes that share its
  heads, adjacent first, then the warps in order.
- ``sdot_only``: each warp sums the scores (and |s|) of its rows (r = w, w
  + 4, ... of every page) in tile order; the warps in order.
  ``reshape_only``: each thread sums |x| over its elements of its rows of
  every K and V tile in tile order; then the lanes' tree and the warps;
  acc00 (kv head 0's K column 0) is summed per warp over its rows, then
  over the warps in order.

Two planted faults must fail the gates: the last V page of each chunk
dropped from the PV, and the chunk max taken over half its rows.
"""

import numpy as np
import pytest
import torch

from scratchpad_tpu_torch.ops.attention.decode_ablate import (
    MODES,
    NEG,
    aux_tolerance,
    decode_ablate_plain,
    lane_dot,
    num_chunks,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

ATOL = 1e-4  # chip_smoke.py's ATOL
WARPS = 4
LENS = [0, 1, 15, 16, 255, 256, 257, 1000]  # around a page (16) and a chunk (256)


def _tree(x: torch.Tensor) -> torch.Tensor:
    """The lanes' halves-first tree over the last dim (32 lanes), as the
    kernel's xor butterfly leaves it in every lane."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _head_tree(v: torch.Tensor, G: int) -> torch.Tensor:
    """``head_tree<NG>``: ``v [..., 32 lanes, NG]`` lane sums of each head;
    returns the scores ``[..., G]``, each read from its head's first lane."""
    NG = 1 << (G - 1).bit_length()
    v = torch.nn.functional.pad(v, (0, NG - G))  # the pad heads' sums: 0
    lanes = torch.arange(32)
    n, off = NG, 16
    while n > 1:
        up = ((lanes & off) != 0)[:, None]
        first, second = v[..., : n // 2], v[..., n // 2 : n]
        send = torch.where(up, first, second)
        keep = torch.where(up, second, first)
        v = keep + send[..., lanes ^ off, :]
        n, off = n // 2, off // 2
    x = v[..., 0]
    off = 16 // NG
    while off:
        x = x + x[..., lanes ^ off]
        off //= 2
    shift = 5 - (NG.bit_length() - 1)
    return x[..., [g << shift for g in range(G)]]


def _lane_sums(q: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Each lane's sum of its products in turn: q [..., G, Dp] and K [...,
    R, Dp] give [..., R, 32, G]."""
    prod = q[..., None, :, :] * K[..., :, None, :]  # [..., R, G, Dp], exact
    Dp = prod.shape[-1]
    prod = prod.reshape(*prod.shape[:-1], 32, Dp // 32)
    x = prod[..., 0]
    for e in range(1, prod.shape[-1]):
        x = x + prod[..., e]
    return x.transpose(-1, -2)  # [..., R, 32, G]


def emulate(q, kv, page_table, seq_lens, mode, chunk_pages, fault=None):
    """``(out, aux, scores)`` in ``csrc/decode_ablate.cu``'s order; scores
    [B, Hq, rows] of the chunks read (for no_pv and full), else None."""
    B, Hq, Dp = q.shape
    _, ps, H2, _ = kv.shape
    Hkv, CP = H2 // 2, chunk_pages
    G, CH = Hq // Hkv, chunk_pages * ps
    nch = num_chunks(seq_lens, CH)
    C = int(nch.max())
    lens = seq_lens.long()
    qf = q.float().reshape(B, Hkv, G, Dp)
    m = torch.full((B, Hkv, G), NEG)
    l = torch.zeros(B, Hkv, G)
    acc = torch.zeros(B, Hkv, G, Dp)
    acc00 = torch.zeros(B)
    own = torch.zeros(B, Hkv)  # dma_only: thread 0's sum
    own_t = torch.zeros(B, Hkv, WARPS, 32)  # reshape_only: each thread's sum of |x|
    col0 = torch.zeros(B, WARPS)
    sl = torch.zeros(B, Hkv, WARPS, G)  # sdot_only: each warp's sums of s and |s|
    sa = torch.zeros(B, Hkv, WARPS, G)
    scores = []
    ps16 = -(-ps // 16) * 16
    for c in range(C):
        live = c < nch  # [B]
        lv = live[:, None, None]
        pages = page_table[:, c * CP : (c + 1) * CP].long()
        rows = kv[pages].float().reshape(B, CP, ps, Hkv, 2, Dp)
        K = rows[..., 0, :].permute(0, 3, 1, 2, 4)  # [B, Hkv, CP, ps, Dp]
        V = rows[..., 1, :].permute(0, 3, 1, 2, 4)
        if mode == "dma_only":
            own = torch.where(live[:, None], own + K[:, :, 0, 0, 0], own)
            continue
        if mode == "reshape_only":
            EPL = Dp // 32
            for T in (K, V):
                for j in range(CP):
                    for r0 in range(0, ps, WARPS):
                        for w in range(min(WARPS, ps - r0)):
                            x = T[:, :, j, r0 + w].abs().reshape(B, Hkv, 32, EPL)
                            for e in range(EPL):
                                own_t[:, :, w] = torch.where(live[:, None, None], own_t[:, :, w] + x[..., e],
                                                             own_t[:, :, w])
            for j in range(CP):  # warp w's lane 0: K_0[r, 0] of its rows r = w, w + 4, ...
                for r0 in range(0, ps, WARPS):
                    for w in range(min(WARPS, ps - r0)):
                        col0[:, w] = torch.where(live, col0[:, w] + K[:, 0, j, r0 + w, 0], col0[:, w])
            continue
        s = _head_tree(_lane_sums(qf[:, :, None], K.reshape(B, Hkv, 1, CH, Dp))[:, :, 0], G)
        s = s.transpose(-1, -2)  # [B, Hkv, G, CH]
        if mode == "sdot_only":
            sr = s.reshape(B, Hkv, G, CP, ps)
            for j in range(CP):
                for r0 in range(0, ps, WARPS):
                    for w in range(min(WARPS, ps - r0)):
                        x = sr[:, :, :, j, r0 + w]
                        sl[:, :, w] = torch.where(lv, sl[:, :, w] + x, sl[:, :, w])
                        sa[:, :, w] = torch.where(lv, sa[:, :, w] + x.abs(), sa[:, :, w])
            continue
        scores.append(s.reshape(B, Hq, CH))
        col = c * CH + torch.arange(CH)
        sm = torch.where(col < lens[:, None, None, None], s, torch.tensor(NEG))
        it = -(-CH // 32)
        pad = it * 32 - CH
        lanes_max = torch.nn.functional.pad(sm, (0, pad), value=NEG).reshape(B, Hkv, G, it, 32)
        if fault == "half_max":
            lanes_max = torch.nn.functional.pad(sm[..., : CH // 2], (0, it * 32 - CH // 2),
                                                value=NEG).reshape(B, Hkv, G, it, 32)
        m_new = torch.maximum(m, lanes_max.amax(dim=(-1, -2)))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sm - m_new[..., None])
        pl_ = torch.nn.functional.pad(p, (0, pad)).reshape(B, Hkv, G, it, 32)
        psum = pl_[..., 0, :]
        for i in range(1, it):
            psum = psum + pl_[..., i, :]
        psum = _tree(psum)
        l = torch.where(lv, psum + l * alpha, l)
        if mode == "full":
            pq = p.to(torch.bfloat16).float()
            kc = torch.nn.functional.pad(pq[:, 0, 0] * K[:, 0, :, :, 0].reshape(B, CH), (0, pad))
            kc = kc.reshape(B, it, 32)
            k00 = kc[:, 0]
            for i in range(1, it):
                k00 = k00 + kc[:, i]
            acc00 = torch.where(live, _tree(k00) + acc00 * alpha[:, 0, 0], acc00)
            acc = torch.where(lv[..., None], acc * alpha[..., None], acc)
            pp = torch.nn.functional.pad(pq.reshape(B, Hkv, G, CP, ps), (0, ps16 - ps))
            Vp = torch.nn.functional.pad(V, (0, 0, 0, ps16 - ps))
            for j in range(CP):
                if fault == "drop_last_v" and j == CP - 1:
                    continue
                for k0 in range(0, ps16, 16):
                    step = pp[:, :, :, j, k0 : k0 + 16] @ Vp[:, :, j, k0 : k0 + 16]
                    acc = torch.where(lv[..., None], acc + step, acc)
        m = torch.where(lv, m_new, m)

    cs = torch.zeros(B, Hkv, G)
    if mode == "dma_only":
        cs = own[..., None].expand(B, Hkv, G)
        a00 = own[:, 0]
    elif mode == "reshape_only":
        per_warp = _tree(own_t)  # [B, Hkv, WARPS]
        cs = (((per_warp[..., 0] + per_warp[..., 1]) + per_warp[..., 2]) + per_warp[..., 3])
        cs = cs[..., None].expand(B, Hkv, G)
        a00 = ((col0[:, 0] + col0[:, 1]) + col0[:, 2]) + col0[:, 3]
    elif mode == "sdot_only":
        l = ((sl[:, :, 0] + sl[:, :, 1]) + sl[:, :, 2]) + sl[:, :, 3]
        cs = ((sa[:, :, 0] + sa[:, :, 1]) + sa[:, :, 2]) + sa[:, :, 3]
        a00 = torch.zeros(B)
    elif mode == "full":
        # warp w: head dims [w Dp / 4, (w + 1) Dp / 4); lane (g, t) holds dims
        # g and g + 8 of each m16 tile, summed in turn; then the lanes of
        # its t, adjacent g first (xor 4, 8, 16)
        MTW = Dp // 16 // WARPS
        a = acc.abs().reshape(B, Hkv, G, WARPS, MTW, 2, 8)  # [.., warp, tile, +8, g]
        v = torch.zeros(B, Hkv, G, WARPS, 8)
        for n in range(MTW):
            v = v + (a[..., n, 0, :] + a[..., n, 1, :])
        while v.shape[-1] > 1:
            v = v[..., 0::2] + v[..., 1::2]
        v = v[..., 0]
        cs = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
        a00 = acc00
    else:
        a00 = torch.zeros(B)
    if mode in ("dma_only", "reshape_only", "sdot_only"):
        m = torch.full((B, Hkv, G), NEG)
        if mode != "sdot_only":
            l = torch.zeros(B, Hkv, G)
    m, l, cs = m.reshape(B, Hq), l.reshape(B, Hq), cs.reshape(B, Hq)
    out = ((m + l) + a00[:, None]).to(torch.bfloat16)[..., None].expand(B, Hq, Dp)
    return out, torch.stack([m, l, cs], dim=-1), torch.cat(scores, -1) if scores else None


def _case(G: int, Dp: int, lens, ps=16, CP=16, Hkv=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = max(max(-(-n // (CP * ps)), 1) for n in lens) * CP
    pages = B * P + 1
    kv = torch.tensor(rng.standard_normal((pages, ps, 2 * Hkv, Dp)), dtype=torch.float32).to(torch.bfloat16)
    q = torch.tensor(rng.standard_normal((B, Hkv * G, Dp)), dtype=torch.float32).to(torch.bfloat16)
    pt = torch.tensor(rng.integers(0, pages, (B, P)), dtype=torch.int32)
    return q, kv, pt, torch.tensor(lens, dtype=torch.int32)


def _gates(out, aux, ref_out, ref_aux, mode) -> tuple[bool, bool, bool]:
    """(out within one bf16 ulp, m exact, l and checksum within tolerance)."""
    r = ref_out.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    ulp_ok = bool(((out.float() - r).abs() <= ulp).all())
    m_ok = bool((aux[..., 0] == ref_aux[..., 0]).all())
    tol = aux_tolerance(ref_aux, mode, ATOL)
    rest_ok = bool(((aux - ref_aux).abs()[..., 1:] <= tol[..., 1:]).all())
    return ulp_ok, m_ok, rest_ok


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("Dp", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_emulated_order_meets_the_card_gates(G, Dp, mode):
    q, kv, pt, lens = _case(G, Dp, LENS, seed=100 * G + Dp)
    out, aux, scores = emulate(q, kv, pt, lens, mode, 16)
    ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode, 16)
    assert _gates(out, aux, ref_out, ref_aux, mode) == (True, True, True)
    if scores is not None:  # the head tree gives lane_dot's bits
        B, Hq, R = scores.shape
        Hkv = kv.shape[2] // 2
        K = kv[pt.long()].float().reshape(B, -1, Hkv, 2, Dp)[:, :R, :, 0]
        want = lane_dot(q.float()[:, :, None], K[:, :, torch.arange(Hq) // G].transpose(1, 2))
        assert torch.equal(scores, want)


def test_emulated_order_with_pages_shorter_than_a_step():
    """Page 8 (half a PV step, its pad rows at p = 0), 4-page chunks."""
    q, kv, pt, lens = _case(4, 64, [0, 1, 7, 8, 31, 32, 33, 100], ps=8, CP=4, seed=7)
    for mode in MODES:
        out, aux, _ = emulate(q, kv, pt, lens, mode, 4)
        ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode, 4)
        assert _gates(out, aux, ref_out, ref_aux, mode) == (True, True, True), mode


@pytest.mark.parametrize(
    "fault,mode,fails",
    [
        ("drop_last_v", "full", (True, True, False)),  # only the PV's checksum sees V
        ("half_max", "no_pv", (False, False, False)),
        ("half_max", "full", (False, False, False)),
    ],
)
@pytest.mark.parametrize("G,Dp", [(4, 128), (3, 64)])
def test_planted_faults_fail_the_gates(G, Dp, fault, mode, fails):
    q, kv, pt, lens = _case(G, Dp, LENS, seed=100 * G + Dp)
    out, aux, _ = emulate(q, kv, pt, lens, mode, 16, fault=fault)
    ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode, 16)
    got = _gates(out, aux, ref_out, ref_aux, mode)
    assert got == fails, got
    assert not all(got)
