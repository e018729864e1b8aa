"""The decode kernel's split plan and arithmetic, on the CPU.

- ``gqa_decode.decode_plan`` at every shape ``chip_smoke.py`` checks and
  times: each (row, kv head, page) falls to exactly one CTA, B 1 at 4096
  tokens launches at least one CTA an SM, and the workspace holds what the
  kernel's indexing reaches (``csrc/paged_decode_attention.cu``: the
  counters, then the partial of split s of (b, h) at ((b Hkv + h) splits +
  s) G (D + 2) floats); the plan's constants are the kernel's.
- A plain emulation of the kernel's arithmetic: the plan's splits of each
  row's pages, from the window's first token; four warps taking 16-token
  slices in turn; per slice the bf16 scores summed in f32 (times the K
  scale on 8-bit pages), the cap, one max and one rescale in log2 units, P
  (times the V scale on 8-bit pages) as bf16 hi + lo (and a third term on
  8-bit pages) into two accumulators; the warps merged in order, then the
  splits in order, one bf16 rounding. Held against the JAX package's
  ``decode_attention_gqa`` (``_gqa_decode_kernel`` in interpret mode) over
  bf16, int8 and fp8 pages at G 1, 3, 4 and 8 and D 32, 64 and 128, with a
  window whose first token falls inside a split, on a split boundary and a
  token either side of one, with the cap, and with rows of 0 and 1 tokens,
  at the card's gate |emu - ref| <= 1e-4 + 2**-8 |ref|. The same emulation
  with P rounded to bf16 once exceeds that gate, which is why the kernel
  splits P.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu_torch.ops.attention import gqa_decode as gd
from scratchpad_tpu_torch.utils import native
from test_torch_attention import LAYER, _case, _decode_metas, _pools
from test_torch_kv_quant import _quant_pools
import torch_threads  # noqa: F401  (one torch thread a test process)

ATOL, RTOL = 1e-4, 2.0**-8  # chip_smoke.py's kernel-vs-plain gate
LOG2E = 1.4426950408889634
SLICE, WARPS = 16, 4  # kSlice, kWarps
PS = 16


# ------------------------------------------------------------- the plan


def _timed_and_checked_shapes():
    """(B, Hkv, pages, D, G) of every decode launch shape chip_smoke.py
    checks and times, at page 16."""
    shapes = set()
    for B, ctx, D, G, *_ in chip_smoke.DECODE_TIMED:
        shapes.add((B, 8, -(-ctx // PS), D, G))
    for G in (4, 3):
        for D in (64, 128):
            for B in chip_smoke.DECODE_CHECK_B:
                for ctx in chip_smoke.DECODE_CHECK_CTX:
                    shapes.add((B, 8, -(-ctx // PS), D, G))
    for B in (1, 64):
        for ctx in (256, 4096, 8192):
            shapes.add((B, 8, -(-ctx // PS), 128, 4))
    return sorted(shapes)


@pytest.mark.parametrize("B,Hkv,pages,D,G", _timed_and_checked_shapes())
def test_decode_plan_covers_every_page_once(B, Hkv, pages, D, G):
    plan = gd.decode_plan(B, Hkv, pages, D, G)
    covered = [p for s in range(plan.splits) for p in range(*plan.page_range(s))]
    assert covered == list(range(pages))  # each (row, head) page in one CTA
    assert all(plan.page_range(s)[1] > plan.page_range(s)[0] for s in range(plan.splits) if pages)
    assert 1 <= plan.splits <= gd.MAX_SPLITS and plan.splits * plan.split_pages >= pages
    assert plan.ctas == plan.splits * Hkv * B
    if plan.splits > 1:
        assert B * Hkv <= gd.COUNTER_SLOTS
        last = ((B - 1) * Hkv + Hkv - 1) * plan.splits + plan.splits - 1
        reached = gd.COUNTER_SLOTS * 4 + (last + 1) * G * (D + 2) * 4
        assert plan.workspace_bytes == reached <= gd.WORKSPACE_BYTES
    if B == 1 and pages >= 256:  # one long row: the split fills the card
        assert plan.ctas >= gd.SMS, plan


def test_attention_ab_times_every_decode_shape_chip_smoke_times():
    from scratchpad_tpu_torch.tools import attention_ab

    assert attention_ab.DECODE_SHAPES == chip_smoke.DECODE_TIMED
    decode = [v[1:] for v in attention_ab.SHAPES.values() if v[0] == "decode"]
    assert decode == [tuple(d) for d in chip_smoke.DECODE_TIMED]


def test_plan_constants_are_the_kernels():
    src = (native.CSRC / "paged_decode_attention.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kMaxSplits") == gd.MAX_SPLITS
    assert const("kDecodeCounterSlots") == gd.COUNTER_SLOTS
    assert const("kSlice") == SLICE and const("kWarps") == WARPS


# -------------------------------------------------- the kernel's arithmetic


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_decode(q, k, v, ks, vs, pt, lens, scale, cap=None, window=None, terms=None):
    """``[B, Hq, D]`` as the kernel computes it: q of bf16 values, k / v the
    pool ``[pages, ps, Hkv, D]`` of bf16 values or 8-bit codes (as f32), ks /
    vs their scales ``[pages, ps, Hkv]`` (None for bf16 pages), pt ``[B,
    P]``, lens ``[B]``. P goes to PV in ``terms`` bf16 terms: the kernel's 2
    (hi + lo) over bf16 pages, 3 over 8-bit pages."""
    terms = terms or (2 if vs is None else 3)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    G = Hq // Hkv
    plan = gd.decode_plan(B, Hkv, pt.shape[1], D, G)
    kf, vf = k.reshape(-1, Hkv, D), v.reshape(-1, Hkv, D)
    ksf = None if ks is None else ks.reshape(-1, Hkv)
    vsf = None if vs is None else vs.reshape(-1, Hkv)
    mul = 1.0 if cap else scale * LOG2E
    span = plan.split_pages * ps
    out = torch.zeros(B, Hq, D)

    def merge(states):
        """(m, l, O) states merged in order: (max, denominator, numerator)."""
        mx = torch.stack([s[0] for s in states]).amax(0)
        mu = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)
        den, num = torch.zeros_like(mx), torch.zeros(Hkv, G, D)
        for m, l, o in states:
            wt = torch.exp2(m - mu)
            den = den + l * wt
            num = num + torch.where(wt[..., None] == 0, torch.zeros_like(o), o * wt[..., None])
        return mx, den, num

    for b in range(B):
        L = int(lens[b])
        first = L - window if window and L > window else 0
        qb = q[b].reshape(Hkv, G, D)
        parts = []
        for s in range(plan.splits):
            lo, hi = max(s * span, first), min(s * span + span, L)
            n = max(0, -(-(hi - lo) // SLICE))
            warps = []
            for w in range(WARPS):
                m = torch.full((Hkv, G), -torch.inf)
                l = torch.zeros(Hkv, G)
                o_hi, o_lo = torch.zeros(Hkv, G, D), torch.zeros(Hkv, G, D)
                for j in range(w, n, WARPS):
                    tok = lo + SLICE * j + torch.arange(SLICE)
                    live = tok < hi
                    slots = torch.where(live, pt[b, (tok // ps).clamp(max=pt.shape[1] - 1)] * ps + tok % ps, 0)
                    kk = torch.where(live[:, None, None], kf[slots], 0.0)  # zero-filled rows
                    vv = torch.where(live[:, None, None], vf[slots], 0.0)
                    sc = torch.einsum("hgd,thd->hgt", qb, kk)  # bf16 products, f32 sums
                    if ksf is not None:
                        sc = sc * torch.where(live[:, None], ksf[slots], 0.0).T[:, None, :]
                    t = (cap * LOG2E) * torch.tanh(sc * (scale / cap)) if cap else sc * mul
                    t = t.masked_fill(~live, -torch.inf)
                    m_new = torch.maximum(m, t.amax(-1))
                    mu = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
                    alpha = torch.exp2(m - mu)
                    p = torch.exp2(t - mu[..., None])
                    l = l * alpha + p.sum(-1)
                    m = m_new
                    if vsf is not None:
                        p = p * torch.where(live[:, None], vsf[slots], 0.0).T[:, None, :]
                    vt = vv.permute(1, 0, 2)  # [Hkv, 16, D]
                    hi_p = _bf16(p)
                    rest = p - hi_p
                    o_hi = o_hi * alpha[..., None] + torch.bmm(hi_p, vt)
                    if terms >= 2:
                        lo_p = _bf16(rest)
                        o_lo = o_lo * alpha[..., None] + torch.bmm(lo_p, vt)
                        if terms == 3:
                            o_hi = o_hi + torch.bmm(_bf16(rest - lo_p), vt)
                    else:
                        o_lo = o_lo * alpha[..., None]
                warps.append((m, l, o_hi + o_lo))
            parts.append(merge(warps))
        if plan.splits == 1:
            _, den, num = parts[0]
        else:
            _, den, num = merge(parts)
        res = torch.where(den[..., None] > 0, num / den[..., None], torch.zeros_like(num))
        out[b] = _bf16(res.reshape(Hq, D))
    return out


def _ratio(out, ref) -> float:
    """The largest |out - ref| over its gate (<= 1 passes)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref) / (ATOL + RTOL * np.abs(ref))))


def _window_lens(long: int, Hkv: int, D: int, G: int, window: int) -> list[int]:
    """Rows around the plan's split boundaries for a page table ``long``
    tokens wide: the window's first token inside a split, on a split
    boundary, one token before and after one, in the first page; a row of 0
    and one of 1 token."""
    plan = gd.decode_plan(7, Hkv, -(-long // PS), D, G)
    span = plan.split_pages * PS
    assert plan.splits > 2 and window < long - 2 * span
    edge = 2 * span  # a split boundary
    return [long, edge + window, edge + window - 1, edge + window + 1, window + 5, 0, 1]


def _inputs(kind, lens, Hkv, D, G, seed):
    """q (bf16 values, f32), the JAX pool and the port's layer of the same
    pages: bf16 values, or the 8-bit codes and scales the JAX writer made."""
    lens = np.asarray(lens, np.int32)
    if kind == "bf16":
        rng, num_pages, pt, loc, k, v = _case(lens.tolist(), Hkv, D, PS, seed)
        k, v = _bf16(torch.from_numpy(k)).numpy(), _bf16(torch.from_numpy(v)).numpy()
        jkv, tkv = _pools(num_pages, PS, Hkv, D, loc, k, v, 128)
    else:
        rng, _, pt, jkv, tkv = _quant_pools(lens.tolist(), Hkv, D, PS, kind, 128, seed)
    q = _bf16(torch.from_numpy(rng.normal(size=(len(lens), Hkv * G, D)).astype(np.float32))).numpy()
    kl, vl, ks, vs = tkv.layer(LAYER)
    pages = tuple(None if t is None else t.float() for t in (kl, vl, ks, vs))
    return lens, pt, q, jkv, pages


# (kind, G, D, cap, window, lens or the long row of _window_lens): every
# kind, G 1, 3, 4, 8 and D 32, 64, 128, windows across split boundaries;
# rows of at most 16 pages without a window, as the JAX kernels take
# seconds a 16-page chunk in interpret mode
EMU_CASES = [
    ("bf16", 4, 64, None, None, [256, 0, 129, 64, 1, 200]),
    ("bf16", 3, 128, None, 100, 1000),
    ("bf16", 8, 32, 30.0, 60, 700),
    ("int8", 1, 32, 30.0, 90, 900),
    ("int8", 3, 128, None, None, [250, 129, 0, 17]),
    ("fp8", 4, 64, None, 100, 1000),
    ("fp8", 8, 128, 30.0, None, [200, 1, 0, 160]),
]


@pytest.mark.parametrize("kind,G,D,cap,window,lens", EMU_CASES)
def test_kernel_arithmetic_meets_the_gate(kind, G, D, cap, window, lens):
    Hkv = 2
    if not isinstance(lens, list):
        lens = _window_lens(lens, Hkv, D, G, window)
    lens, pt, q, jkv, (k, v, ks, vs) = _inputs(kind, lens, Hkv, D, G, seed=G * D + len(lens))
    if cap:
        q = q * 8.0  # scores that reach the cap (chip_smoke.py's CAP_Q_SCALE)
    scale = 1.0 / np.sqrt(D)
    jm, _ = _decode_metas(pt, lens)
    ref = np.asarray(jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=PS, sm_scale=scale,
                             logit_cap=cap, sliding_window=window))
    emu = emulate_decode(torch.from_numpy(q), k, v, ks, vs, torch.from_numpy(pt).long(),
                         torch.from_numpy(lens), scale, cap, window).numpy()
    assert gd.decode_plan(len(lens), Hkv, pt.shape[1], D, G).splits > 1  # the cases split
    assert _ratio(emu, ref) <= 1.0
    assert not emu[lens == 0].any()


def test_one_bf16_rounding_of_p_exceeds_the_gate():
    """Six rows of up to 2,000 tokens, G 4, D 64, bf16 pages: P rounded once
    to bf16 misses the gate that P as bf16 hi + lo meets."""
    Hkv, G, D = 2, 4, 64
    lens, pt, q, jkv, (k, v, _, _) = _inputs("bf16", [2000, 1500, 1999, 1024, 777, 1800], Hkv, D, G, 7)
    q = q * 3.0  # peaked rows: the largest p carry the rounding
    scale = 1.0 / np.sqrt(D)
    jm, _ = _decode_metas(pt, lens)
    ref = np.asarray(jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=PS, sm_scale=scale))
    args = (torch.from_numpy(q), k, v, None, None, torch.from_numpy(pt).long(), torch.from_numpy(lens), scale)
    split = emulate_decode(*args).numpy()
    single = emulate_decode(*args, terms=1).numpy()
    assert _ratio(split, ref) <= 1.0 < _ratio(single, ref)
