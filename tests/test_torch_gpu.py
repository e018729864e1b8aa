"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device exists. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: |kernel - plain| <= 1e-4 + 2**-8 * |plain| on bf16 inputs, the
plain version computing in f32 and returning f32. Every kernel accumulates in
f32 and rounds only its output to bf16, which moves a value by at most 2**-8
of itself; 1e-4 covers the order of the f32 sums. The W4 GEMMs get the same
int8 rows as their plain versions, and the row quantizer must match its
plain version bit for bit. The attention kernels over int8 and fp8 pages are
held to the plain version's f32 dequantize-then-attend at the same
tolerance, and the KV quantizer on the card to itself on the CPU, bit for
bit. The grouped delta kernel is held to its plain version's f32 sum on the
rows of delta slots, and every other row must come out bit-equal to the
input. The W4A16 and delta kernels are also held at the edges of their
launch plans (64 | 65 rows, one and two 128-row tiles, an Out of 1000), and
where a plan splits K, two calls must give the same bits. The attention kernels with a soft cap and a static sliding window are
held to their plain versions at Mistral-7B's shape (G 4, head_dim 128) at
the same tolerance, over bf16, int8 and fp8 pages, the window's edge inside
a page and inside a 64-token KV tile, the extend also at head_dim 32 and 64
with one and eight query heads per kv head; a window at least as long as the
context gives the kernel's no-window output bit for bit. Both attention
kernels at head_dim 256 (Gemma) with caps and windows over bf16, int8 and
fp8 pages, and windows that change from call to call on one pool.
Both attention kernels with attention sinks (GPT-OSS's shape: Hkv 8, G 8,
head_dim 64) over bf16, int8 and fp8 pages, with and without its window of
128, a split launch (B 1, ctx 4096) bit-equal on a repeat, sinks far below
and far above every score, and zero rows exact zeros. Both attention
kernels with Llama-4's chunk (G 4 and 5, head_dim 128, chunks of 16 to
8192) over bf16, int8 and fp8 pages, rows at chunk edges, a split launch
bit-equal on a repeat, extend tiles that straddle an edge. The decode
ablation probe's ``out`` must lie within one bf16 ulp of its plain
version's (both round the same f32 statistic to bf16 once), its ``aux``
within ``aux_tolerance`` (m exact, the rest ATOL + 2**-12 |plain|); the
decode kernel's stage cuts are held to their plain functions at ATOL + RTOL
|plain|, and the profiling tools run at small sizes. Three engines on the
card through ``chip_smoke.py``'s phases: custom logit processors on a tiny
Llama (banned ids absent, a per-row boost, free rows unchanged, no
processor row in a pipelined window), a small DeepSeek-V2 of
DeepSeek-V2-Lite's structure, whose absorbed latent attention must launch no
attention kernel and hold its logits to HF's expanded form within 3e-2 of
max |logit| at one routing, the rope term moving them by 10x that, and a
narrow Mllama of Llama-3.2-11B-Vision's structure through
``phase_mllama``.
"""

import math

import numpy as np
import pytest
import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.ops.attention import (
    decode_attention_pallas,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_quant,
    paged_extend_attention,
    paged_extend_attention_plain,
    paged_extend_attention_quant,
    quantize_rows,
)
from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, delta_matmul_grouped_plain
from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    pack_w4,
    padded_in,
    quantize_activations_plain,
    quantize_rows_int8,
    w4a8_matmul,
    w4a8_matmul_plain,
    w4a16_matmul,
    w4a16_matmul_plain,
)
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked

pytestmark = pytest.mark.gpu


ATOL, RTOL = 1e-4, 2.0**-8


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _pool(lens, Hkv, D, ps, gen):
    need = [max(-(-n // ps), 1) for n in lens]
    total = sum(need) + 1
    perm = torch.randperm(total - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(len(lens), max(need), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[o : o + n].to(torch.int32)
        o += n
    shape = (total, ps, Hkv, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, pt


def _quantized(k, v, code_dtype):
    """bf16 pages as 8-bit codes and bf16 scales, through the KV quantizer."""
    kc, ks = quantize_rows(k, code_dtype)
    vc, vs = quantize_rows(v * 0.05, code_dtype)  # V on another scale than K
    return kc, vc, ks, vs


def _close(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.float32
    d = (out.float() - ref).abs()
    assert bool((d <= ATOL + RTOL * ref.abs()).all()), float(d.max())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("lens", [[256, 0, 17, 200], [1500], [4096, 3000, 1]])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_decode_kernel_matches_plain(gen, D, lens, G):
    Hkv, ps = 4, 16
    k, v, pt = _pool(lens, Hkv, D, ps, gen)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k, v, pt, seq, 1 / math.sqrt(D))
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, 1 / math.sqrt(D)))
    assert bool((out[seq == 0] == 0).all())


@pytest.mark.parametrize("code_dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("lens", [[256, 0, 17, 200], [4096, 3000, 1]])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_quant_decode_kernel_matches_plain(gen, code_dtype, D, lens, G):
    Hkv, ps = 4, 16
    k, v, pt = _pool(lens, Hkv, D, ps, gen)
    kc, vc, ks, vs = _quantized(k, v, code_dtype)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(D)
    out = paged_decode_attention_quant(q, kc, vc, ks, vs, pt, seq, scale)
    _close(out, paged_decode_attention_plain(q.float(), kc, vc, pt, seq, scale, ks, vs))
    assert bool((out[seq == 0] == 0).all())


def _extend_case(Hkv, D, G, gen):
    chunks = [(100, 100), (64, 600), (1, 33), (0, 0), (250, 250)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, pt, kv_lens, cu


@pytest.mark.parametrize("code_dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_quant_extend_kernel_matches_plain(gen, code_dtype, D, G):
    q, k, v, pt, kv_lens, cu = _extend_case(2, D, G, gen)
    kc, vc, ks, vs = _quantized(k, v, code_dtype)
    out = paged_extend_attention_quant(q, kc, vc, ks, vs, pt, kv_lens, cu, 0.1)
    _close(out, paged_extend_attention_plain(q.float(), kc, vc, pt, kv_lens, cu, 0.1, ks, vs))
    assert bool((out[int(cu[-1]) :] == 0).all())


@pytest.mark.parametrize("code_dtype", [torch.int8, torch.float8_e4m3fn])
def test_kv_quantizer_on_the_card_is_bit_exact(gen, code_dtype):
    """quantize_rows on CUDA tensors against the same function on the CPU:
    random rows over six decades, a zero row, and rows whose bf16 scale
    rounds down so that |x / scale| passes the code range (127.49, 449.7)."""
    x = torch.randn(300, 8, 128, generator=gen, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, (300, 8, 1), generator=gen, device="cuda")
    x[7] = 0
    limit = 127.0 if code_dtype == torch.int8 else 448.0
    x[11, :, :16] = torch.linspace(-limit * 1.0039, limit * 1.0039, 16, device="cuda")
    x[11, :, 16:] = 0
    for xb in (x, x.to(torch.bfloat16)):
        codes, scale = quantize_rows(xb, code_dtype)
        ref_codes, ref_scale = quantize_rows(xb.cpu(), code_dtype)
        torch.cuda.synchronize()
        assert torch.equal(codes.view(torch.uint8).cpu(), ref_codes.view(torch.uint8))
        assert torch.equal(scale.cpu(), ref_scale)
        assert bool(torch.isfinite(codes.float()).all())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_extend_kernel_matches_plain(gen, D, G):
    Hkv, ps = 2, 16
    chunks = [(100, 100), (64, 600), (1, 33), (0, 0), (250, 250)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, ps, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1)
    _close(out, paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 0.1))
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """A CUDA tensor reaches the kernel or raises; nothing falls back."""
    k, v, pt = _pool([40], 2, 64, 16, gen)
    seq = torch.tensor([40], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 64, device="cuda")
    with pytest.raises(TypeError):  # f32 q
        paged_decode_attention(q, k, v, pt, seq, 0.1)
    with pytest.raises(ValueError):  # head_dim 48
        paged_decode_attention(
            q[..., :48].bfloat16().contiguous(), k[..., :48].contiguous(),
            v[..., :48].contiguous(), pt, seq, 0.1,
        )
    with pytest.raises(TypeError):  # i64 page table
        paged_decode_attention(q.bfloat16(), k, v, pt.long(), seq, 0.1)
    cu = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # q on another device than the pool
        paged_extend_attention(q.bfloat16().cpu(), k, v, pt, seq, cu, 0.1)


def test_quant_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """The 8-bit attention wrappers launch or raise: other head dims, groups
    above 8 (decode), other code dtypes, scales that are not bf16 or not
    [pages, ps, Hkv], and bf16 pages."""
    k, v, pt = _pool([40], 2, 64, 16, gen)
    kc, vc, ks, vs = _quantized(k, v, torch.int8)
    seq = torch.tensor([40], dtype=torch.int32, device="cuda")
    cu = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 64, device="cuda").to(torch.bfloat16)
    dec = lambda *a: paged_decode_attention_quant(*a, pt, seq, 0.1)
    ext = lambda *a: paged_extend_attention_quant(*a, pt, seq, cu, 0.1)
    for fn in (dec, ext):
        with pytest.raises(TypeError):  # bf16 pages
            fn(q, k, v, ks, vs)
        with pytest.raises(TypeError):  # u8 codes
            fn(q, kc.view(torch.uint8), vc.view(torch.uint8), ks, vs)
        with pytest.raises(TypeError):  # f32 scales
            fn(q, kc, vc, ks.float(), vs.float())
        with pytest.raises(ValueError):  # scales of another shape
            fn(q, kc, vc, ks[:, :8].contiguous(), vs[:, :8].contiguous())
        with pytest.raises(ValueError):  # head_dim 48
            fn(q[..., :48].contiguous(), kc[..., :48].contiguous(), vc[..., :48].contiguous(), ks, vs)
        with pytest.raises(TypeError):  # f32 q
            fn(q.float(), kc, vc, ks, vs)
    with pytest.raises(ValueError):  # group 9 at decode
        dec(torch.randn(1, 18, 64, device="cuda").to(torch.bfloat16), kc, vc, ks, vs)


# (logit_cap, sliding_window) of the windowed checks: edges mid-page (1000),
# on a page edge (4096), a window of one token
CAPS_WINDOWS = [(50.0, None), (None, 4096), (None, 1000), (30.0, 1000), (None, 1)]
CODE_DTYPES = {"bf16": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _capped(q, cap):
    """q scaled up for a capped case, so that scores reach the cap (unit q
    and K give N(0, 1) scores, which a cap of 30 hardly moves)."""
    return q if cap is None else (q.float() * 8.0).to(q.dtype)


def _pages(kind, k, v):
    if CODE_DTYPES[kind] is None:
        return k, v, None, None
    return _quantized(k, v, CODE_DTYPES[kind])


def _decode(q, k, v, ks, vs, pt, seq, scale, cap, window):
    if ks is None:
        return paged_decode_attention(q, k, v, pt, seq, scale, cap, window)
    return paged_decode_attention_quant(q, k, v, ks, vs, pt, seq, scale, cap, window)


def _extend(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window):
    if ks is None:
        return paged_extend_attention(q, k, v, pt, kv_lens, cu, scale, cap, window)
    return paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)


# (G, D) of the plan-edge checks: G 1 to 8, each head_dim at several G
EDGE_GROUPS = [(1, 32), (2, 64), (3, 128), (4, 64), (5, 32), (6, 128), (7, 64), (8, 128)]
# (B, ctx): one row (split across the card), two, the bench's 64; contexts
# on either side of a page edge, one long and one longer (not at B 64: the
# plain version's f32 gather of 64 x 8192 rows)
EDGE_ROWS = [(B, ctx) for B in (1, 2, 64) for ctx in (1, 15, 16, 17, 4096, 8192) if (B, ctx) != (64, 8192)]


def _decode_checked(kind, q, k, v, ks, vs, pt, seq, scale, cap=None, window=None):
    """The kernel against its plain version, zero rows exact, and where the
    plan splits a row, a second call bit-equal."""
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    out = _decode(q, k, v, ks, vs, pt, seq, scale, cap, window)
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, scale, ks, vs, cap, window))
    assert bool((out[seq == 0] == 0).all())
    plan = decode_plan(q.shape[0], k.shape[2], pt.shape[1], q.shape[2], q.shape[1] // k.shape[2])
    if plan.splits > 1:
        assert torch.equal(out, _decode(q, k, v, ks, vs, pt, seq, scale, cap, window))
    return plan


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("B,ctx", EDGE_ROWS)
@pytest.mark.parametrize("G,D", EDGE_GROUPS)
def test_decode_kernel_at_the_plans_edges(gen, kind, B, ctx, G, D):
    """Rows of ctx // 2 to ctx tokens (the first of ctx, the last of 0 where
    B > 1) over Hkv 8, page 16: split where B * Hkv is short of the card."""
    Hkv = 8
    lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
    lens[0] = ctx
    if B > 1:
        lens[-1] = 0
    lens = lens.tolist()
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    plan = _decode_checked(kind, q, k, v, ks, vs, pt, seq, 1 / math.sqrt(D))
    if B == 1 and ctx >= 4096:
        assert plan.ctas >= 132


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("G,D", [(4, 128), (3, 128), (1, 32), (8, 64)])
@pytest.mark.parametrize("cap,window", [(None, None), (None, 1000), (30.0, 4096), (None, 1)])
def test_decode_kernel_at_split_boundaries(gen, kind, G, D, cap, window):
    """Rows whose last token (or the window's first) falls one token before,
    on and one token after a boundary of the plan's splits, at 8192 tokens;
    windows that cross splits; the cap."""
    import chip_smoke

    Hkv = 8
    edge_window = window if window and window > 1 else None
    lens = chip_smoke.split_edge_lens(8192, Hkv, D, G, edge_window, batch=6) + [0, 1]
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q = _capped(torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16), cap)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    plan = _decode_checked(kind, q, k, v, ks, vs, pt, seq, 1 / math.sqrt(D), cap, window)
    assert plan.splits > 1


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("cap, window", CAPS_WINDOWS)
def test_windowed_decode_kernel_matches_plain(gen, kind, cap, window):
    """Mistral-7B's decode shape (Hq 32, Hkv 8, D 128), contexts past and
    inside the window, a padding row."""
    Hkv, G, D, ps = 8, 4, 128, 16
    lens = [8192, 0, 1000, 4097, 1]
    k, v, pt = _pool(lens, Hkv, D, ps, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    q = _capped(q, cap)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(D)
    out = _decode(q, k, v, ks, vs, pt, seq, scale, cap, window)
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, scale, ks, vs, cap, window))
    assert bool((out[seq == 0] == 0).all())


def _windowed_extend_case(Hkv, D, G, gen):
    # a 2048-token chunk on 6,000 cached tokens; chunks whose window edge
    # falls inside a query tile and a page; a fresh prompt; padding tokens
    chunks = [(2048, 8048), (100, 1100), (37, 1037), (0, 0), (300, 300)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 29
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, pt, kv_lens, cu


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("cap, window", CAPS_WINDOWS)
def test_windowed_extend_kernel_matches_plain(gen, kind, cap, window):
    q, k, v, pt, kv_lens, cu = _windowed_extend_case(8, 128, 4, gen)
    q = _capped(q, cap)
    k, v, ks, vs = _pages(kind, k, v)
    scale = 1 / math.sqrt(128)
    out = _extend(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)
    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs, cap, window)
    _close(out, ref)
    assert bool((out[int(cu[-1]) :] == 0).all())


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("cap, window", [(None, 100), (30.0, 37)])
def test_windowed_extend_other_heads_match_plain(gen, kind, D, G, cap, window):
    """head_dim 32 and 64, one and eight query heads per kv head (64 and 8
    query tokens a 64-row tile), the window's edge inside a 64-token KV tile
    and inside a page: windows of 100 and 37 over chunks of 300 on 1,000,
    45 on 190 and 1 on 77 cached tokens, a fresh prompt and padding."""
    chunks = [(300, 1000), (45, 190), (1, 77), (0, 0), (128, 128)]
    k, v, pt = _pool([c[1] for c in chunks], 2, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]) + 21, 2 * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    q = _capped(q, cap)
    scale = 1 / math.sqrt(D)
    out = _extend(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)
    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs, cap, window)
    _close(out, ref)
    assert bool((out[int(cu[-1]) :] == 0).all())


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
def test_window_past_the_context_changes_nothing(gen, kind):
    """A window at least as long as every context gives the no-window
    kernels' output bit for bit."""
    q, k, v, pt, kv_lens, cu = _windowed_extend_case(8, 128, 4, gen)
    k, v, ks, vs = _pages(kind, k, v)
    for window in (8048, 1 << 30):
        a = _extend(q, k, v, ks, vs, pt, kv_lens, cu, 0.1, None, None)
        b = _extend(q, k, v, ks, vs, pt, kv_lens, cu, 0.1, None, window)
        assert torch.equal(a, b)
        qd = q[: kv_lens.shape[0]].contiguous()  # one query a sequence
        a = _decode(qd, k, v, ks, vs, pt, kv_lens, 0.1, None, None)
        b = _decode(qd, k, v, ks, vs, pt, kv_lens, 0.1, None, window)
        assert torch.equal(a, b)


# head_dim 256 (Gemma; bf16 pages): (G, Hkv) of Gemma-2-2B, Gemma-3-1B and
# the widest group, and (cap, window) pairs of Gemma's layers
HEAD256_GROUPS = [(2, 4), (4, 1), (8, 1)]
HEAD256_CAPS_WINDOWS = [(None, None), (50.0, None), (None, 4096), (50.0, 512), (None, 1)]


def _scaled_for_cap(q, cap):
    """q scaled up so that the scores reach a cap of 50."""
    return q if cap is None else (q.float() * 8).to(torch.bfloat16)


@pytest.mark.parametrize("G,Hkv", HEAD256_GROUPS)
@pytest.mark.parametrize("lens", [[256, 0, 17, 200], [4096, 3000, 1], [8192]])
@pytest.mark.parametrize("cap,window", HEAD256_CAPS_WINDOWS)
def test_decode_kernel_at_head_dim_256(gen, G, Hkv, lens, cap, window):
    D = 256
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    q = _scaled_for_cap(torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16), cap)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k, v, pt, seq, 1 / 16, cap, window)
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, 1 / 16, None, None, cap, window))
    assert bool((out[seq == 0] == 0).all())


@pytest.mark.parametrize("G,Hkv", HEAD256_GROUPS[:2])
@pytest.mark.parametrize("cap,window", HEAD256_CAPS_WINDOWS + [(None, 37)])
def test_extend_kernel_at_head_dim_256(gen, G, Hkv, cap, window):
    D = 256
    chunks = [(100, 100), (64, 600), (1, 33), (0, 0), (250, 250), (600, 5000)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = _scaled_for_cap(torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16), cap)
    out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 1 / 16, cap, window)
    _close(out, paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 1 / 16, None, None, cap, window))
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_head_dim_256_windows_are_per_call(gen):
    """Gemma's layers in turn on one pool, local (4096), global, local: the
    two local calls give the same bits, the global one differs."""
    D, G, Hkv = 256, 2, 4
    lens = [8000, 5000, 4097]
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    outs = [paged_decode_attention(q, k, v, pt, seq, 1 / 16, None, w) for w in (4096, None, 4096)]
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])
    cu = torch.tensor([0, 600, 900, 901], dtype=torch.int32, device="cuda")
    qe = torch.randn(901, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    outs = [paged_extend_attention(qe, k, v, pt, seq, cu, 1 / 16, None, w) for w in (4096, None, 4096)]
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])


CODES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("G,Hkv", HEAD256_GROUPS)
@pytest.mark.parametrize("lens", [[256, 0, 17, 200], [4096, 3000, 1], [8192]])
@pytest.mark.parametrize("cap,window", HEAD256_CAPS_WINDOWS)
def test_8bit_decode_kernel_at_head_dim_256(gen, code, G, Hkv, lens, cap, window):
    """Row 1dq: 8-bit pages at head_dim 256 (Gemma on int8 or fp8 KV); a
    split launch (one row of 8192) gives the same bits on a repeat."""
    D = 256
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    kc, vc, ks, vs = _quantized(k, v, CODES[code])
    q = _scaled_for_cap(torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16), cap)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_decode_attention_quant(q, kc, vc, ks, vs, pt, seq, 1 / 16, cap, window)
    _close(out, paged_decode_attention_plain(q.float(), kc, vc, pt, seq, 1 / 16, ks, vs, cap, window))
    assert bool((out[seq == 0] == 0).all())
    if len(lens) == 1:
        assert torch.equal(out, paged_decode_attention_quant(q, kc, vc, ks, vs, pt, seq, 1 / 16, cap, window))


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("G,Hkv", HEAD256_GROUPS[:2])
@pytest.mark.parametrize("cap,window", HEAD256_CAPS_WINDOWS + [(None, 37)])
def test_8bit_extend_kernel_at_head_dim_256(gen, code, G, Hkv, cap, window):
    """Row 3dq: the extend kernel's own layout for 8-bit pages at head_dim
    256 (codes converted from registers), on mixed chunks, a cached prefix
    and padding tokens."""
    D = 256
    chunks = [(100, 100), (64, 600), (1, 33), (0, 0), (250, 250), (600, 5000)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    kc, vc, ks, vs = _quantized(k, v, CODES[code])
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = _scaled_for_cap(torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16), cap)
    out = paged_extend_attention_quant(q, kc, vc, ks, vs, pt, kv_lens, cu, 1 / 16, cap, window)
    _close(out, paged_extend_attention_plain(q.float(), kc, vc, pt, kv_lens, cu, 1 / 16, ks, vs, cap, window))
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_pallas_decode_wrapper_matches_plain(gen):
    """Row 9's wrapper at its JAX test's shape (B 4, Hq 8, Hkv 2, D 64,
    page 16), cap 30 and window 8, a padding row: the decode kernel through
    ``decode_attention_pallas``, which counts its own launch; an 8-bit pool
    raises."""
    lens = [200, 0, 37, 255]
    k, v, pt = _pool(lens, 2, 64, 16, gen)
    q = _capped(torch.randn(4, 8, 64, generator=gen, device="cuda").to(torch.bfloat16), 30.0)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = torch.arange(4, device="cuda")
    meta = ForwardMeta(
        mode=ForwardMode.DECODE, tokens=rows, positions=rows, out_cache_loc=rows,
        req_indices=rows, page_table=pt, seq_lens=seq, extend_lens=torch.ones_like(seq),
        last_token_idx=rows,
    )
    before = (decode_attention_pallas.launches, paged_decode_attention.launches)
    out = decode_attention_pallas(q, KVCache(k[None], v[None]), 0, meta, sm_scale=0.125,
                                  logit_cap=30.0, sliding_window=8)
    assert (decode_attention_pallas.launches, paged_decode_attention.launches) == (
        before[0] + 1, before[1] + 1
    )
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, 0.125, None, None, 30.0, 8))
    assert bool((out[1] == 0).all())
    kc, vc, ks, vs = _quantized(k, v, torch.int8)
    with pytest.raises(TypeError):
        decode_attention_pallas(q, KVCache(kc[None], vc[None], ks[None], vs[None]), 0, meta,
                                sm_scale=0.125)


# (In, Out) -> quantize_stacked's group: 128; 120 (GPT-OSS's half-plane
# rule); 100, not a multiple of 8; and a padded Out (out_true 200)
W4_SHAPES = [(256, 256), (240, 256), (200, 128), (128, 200)]


def _w4_weight(In, Out, seed):
    w = np.random.default_rng(seed).normal(size=(1, In, Out)).astype(np.float32)
    ql = quantize_stacked(w / np.sqrt(In))
    q, s, z = pack_w4(ql)
    return q[0].cuda(), s[0].cuda(), z[0].cuda(), ql.group_size, ql.out_features


def _w4_rows(M, In, gen):
    x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
    x[M // 2] = 0  # a padding row
    return x


@pytest.mark.parametrize("M", [1, 5, 64, 300])
@pytest.mark.parametrize("In,g", [(2048, 128), (240, 120), (200, 100), (262, 1)])
def test_quantize_rows_is_bit_exact(gen, M, In, g):
    x = _w4_rows(M, In, gen)
    # exact ties: a row with amax 127 has ax == 1, so x / ax lands on .5
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    out = quantize_rows_int8(x, g)
    ref = quantize_activations_plain(x, g)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if M > 1:  # the zero row is not the row of ties
        assert float(out[1][M // 2]) == 1.0 and not out[0][M // 2].any() and not out[2][M // 2].any()


@pytest.mark.parametrize("M", [1, 5, 64, 300])
@pytest.mark.parametrize("In,Out", W4_SHAPES)
def test_w4a8_kernel_matches_plain(gen, M, In, Out):
    q, s, z, g, out_f = _w4_weight(In, Out, seed=In + Out)
    x8, ax, gsum = quantize_rows_int8(_w4_rows(M, In, gen), g)
    out = w4a8_matmul(x8, ax, gsum, q, s, z, g, out_f)
    _close(out, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, out_f))
    assert out.shape == (M, out_f) and not out[M // 2].any()


@pytest.mark.parametrize("M", [1, 5, 64, 300])
@pytest.mark.parametrize("In,Out", W4_SHAPES)
def test_w4a16_kernel_matches_plain(gen, M, In, Out):
    q, s, z, g, out_f = _w4_weight(In, Out, seed=In + Out)
    x = _w4_rows(M, In, gen)
    out = w4a16_matmul(x, q, s, z, g, out_f)
    _close(out, w4a16_matmul_plain(x, q, s, z, g, out_f))
    assert out.shape == (M, out_f) and not out[M // 2].any()


def test_w4_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q, s, z, g, out_f = _w4_weight(256, 256, seed=0)
    x = _w4_rows(4, 256, gen)
    with pytest.raises(TypeError):  # f32 activations
        quantize_rows_int8(x.float(), g)
    with pytest.raises(TypeError):
        w4a16_matmul(x.float(), q, s, z, g, out_f)
    with pytest.raises(ValueError):  # a group that does not tile In
        quantize_rows_int8(x, 96)
    x8, ax, gsum = quantize_rows_int8(x, g)
    with pytest.raises(ValueError):  # In of 128 against a 256-row weight
        w4a16_matmul(x[:, :128].contiguous(), q, s, z, g, out_f)
    with pytest.raises(ValueError):  # f32 scales
        w4a8_matmul(x8, ax, gsum, q, s.float(), z, g, out_f)
    with pytest.raises(ValueError):  # weights on the CPU, activations on the card
        w4a8_matmul(x8, ax, gsum, q.cpu(), s.cpu(), z.cpu(), g, out_f)


# Llama-3.2-1B's quantized matrices (In, Out), gate|up fused and the head
LLAMA_1B_W4 = {
    "wq": (2048, 2048), "wk": (2048, 512), "wo": (2048, 2048), "gate_up": (2048, 16384),
    "down": (8192, 2048), "lm_head": (2048, 128256),
}


def _random_w4(In, Out, gen, g=128, zeros=(0, 16)):
    """Random packed codes with bf16 scales in [0.005, 0.02) and integral
    zero points in ``[zeros[0], zeros[1])``, as chip_smoke.py's
    ``random_w4``."""
    q = torch.randint(0, 256, (Out, padded_in(In) // 2), generator=gen, device="cuda", dtype=torch.uint8)
    s = (torch.rand(In // g, Out, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
    z = torch.randint(*zeros, (In // g, Out), generator=gen, device="cuda").to(torch.bfloat16)
    return q, s, z


@pytest.mark.parametrize("M", [65, 129, 200])
@pytest.mark.parametrize("name", list(LLAMA_1B_W4))
def test_w4a16_kernel_matches_plain_at_the_plan_edges(gen, name, M):
    """The Hopper kernel's row edges (64 | 65, one and two 128-row tiles) at
    the 1B's matrices; the zero row exact."""
    In, Out = LLAMA_1B_W4[name]
    q, s, z = _random_w4(In, Out, gen)
    x = _w4_rows(M, In, gen)
    out = w4a16_matmul(x, q, s, z, 128, Out)
    _close(out, w4a16_matmul_plain(x, q, s, z, 128, Out))
    assert not out[M // 2].any()


@pytest.mark.parametrize("name,M", [("wq", 64), ("wk", 64), ("down", 64), ("wk", 65), ("wq", 5)])
def test_w4a16_split_k_is_bit_exact(gen, name, M):
    """Two calls of a plan that splits K give the same bits (the last CTA
    of a tile adds the partials in split order)."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import w4a16_plan

    In, Out = LLAMA_1B_W4[name]
    assert w4a16_plan(M, Out, In, 128, Out).splits > 1
    q, s, z = _random_w4(In, Out, gen)
    x = _w4_rows(M, In, gen)
    a = w4a16_matmul(x, q, s, z, 128, Out)
    b = w4a16_matmul(x, q, s, z, 128, Out)
    assert torch.equal(a, b)
    _close(a, w4a16_matmul_plain(x, q, s, z, 128, Out))


# W4A8 at the edges of its plan (csrc/w4a8_matmul.cu): (In, Out, group).
# The 1B's matrices (g 128), an Out no tile width divides (1000), groups of
# 64 and 32 (folds inside a k block), a K that is no multiple of 128 (320,
# g 32), GPT-OSS's g 120 and g 100 (split steps; K 1800 ends inside a
# step), g 33 (the least group of the split path) and g 24, which takes the
# mma.sync kernel
W4A8_EDGE_SHAPES = [
    (2048, 2048, 128), (2048, 512, 128), (8192, 2048, 128), (2048, 1000, 64), (1024, 384, 32),
    (320, 1000, 32), (2880, 5760, 120), (1800, 1000, 100), (264, 1000, 33), (2880, 1000, 24),
]


@pytest.mark.parametrize("M", [1, 63, 64, 65, 129, 200])
@pytest.mark.parametrize("In,Out,g", W4A8_EDGE_SHAPES)
def test_w4a8_kernel_matches_plain_at_the_plan_edges(gen, In, Out, g, M):
    """The decode kernel's token tiles (M 1 to 64: 8 and 64 wide), the
    prefill tile's row edges (65, 129, 200); the zero row exact."""
    q, s, z = _random_w4(In, Out, gen, g)
    x8, ax, gsum = quantize_rows_int8(_w4_rows(M, In, gen), g)
    out = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
    _close(out, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
    assert out.shape == (M, Out) and not out[M // 2].any()


@pytest.mark.parametrize("In,Out,g,M", [
    (2048, 2048, 128, 64), (2048, 512, 128, 64), (8192, 2048, 128, 64), (2048, 512, 128, 5),
    (2048, 512, 128, 129), (1024, 384, 32, 64), (320, 1000, 32, 200), (2880, 5760, 120, 64),
    (1800, 1000, 100, 5), (1800, 1000, 100, 200),
])
def test_w4a8_split_k_is_bit_exact(gen, In, Out, g, M):
    """Two calls of a plan that splits K give the same bits."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import w4a8_plan

    assert w4a8_plan(M, Out, In, g, Out).splits > 1
    q, s, z = _random_w4(In, Out, gen, g)
    x8, ax, gsum = quantize_rows_int8(_w4_rows(M, In, gen), g)
    a = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
    b = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
    assert torch.equal(a, b)
    _close(a, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))


# zero points outside the code range (-8..24, as chip_smoke.py's
# W4_REST_ZEROS) at a K whose last k block has zero-filled steps: 320 at
# prefill (g 32 and 64: 128-deep blocks), 352 at decode (352 % 64 == 32);
# and at groups that cut a step, whose rest is added at a split step's
# first fold (1800, g 100, K inside a step; 2880, g 120)
@pytest.mark.parametrize("In,Out,g,M", [
    (320, 1000, 32, 65), (320, 1000, 32, 200), (320, 1000, 64, 65), (320, 1000, 64, 200),
    (352, 1000, 32, 5), (352, 1000, 32, 63), (352, 1000, 32, 64), (352, 512, 32, 200),
    (1800, 1000, 100, 5), (1800, 1000, 100, 64), (1800, 1000, 100, 200), (2880, 1000, 120, 300),
])
def test_w4a8_and_w4a16_zero_rests_past_k(gen, In, Out, g, M):
    """W4A8 adds a group's rest once, at the group's last step inside K,
    and a split K's second call gives the same bits; W4A16 on the same
    weights."""
    q, s, z = _random_w4(In, Out, gen, g, zeros=(-8, 25))
    x = _w4_rows(M, In, gen)
    x8, ax, gsum = quantize_rows_int8(x, g)
    a = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
    _close(a, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
    assert torch.equal(a, w4a8_matmul(x8, ax, gsum, q, s, z, g, Out))
    assert not a[M // 2].any()
    y16 = w4a16_matmul(x, q, s, z, g, Out)
    _close(y16, w4a16_matmul_plain(x, q, s, z, g, Out))
    assert not y16[M // 2].any()


# W4A16 at groups that cut a 16-deep step (split steps): GPT-OSS's g 120 and
# g 100 (K 1800 ends inside a step), g 24 and g 17 (K 272: the least odd
# group of the split path), at the decode and prefill tiles' edges
W4A16_SPLIT_SHAPES = [(2880, 5760, 120), (1800, 1000, 100), (2880, 1000, 24), (272, 1000, 17)]


@pytest.mark.parametrize("M", [1, 64, 65, 129, 300])
@pytest.mark.parametrize("In,Out,g", W4A16_SPLIT_SHAPES)
def test_w4a16_split_steps_match_plain(gen, In, Out, g, M):
    """The split steps of the Hopper kernel against the plain version; where
    the plan splits K, a second call gives the same bits."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import w4a16_plan

    plan = w4a16_plan(M, Out, In, g, Out)
    assert plan is not None
    q, s, z = _random_w4(In, Out, gen, g)
    x = _w4_rows(M, In, gen)
    out = w4a16_matmul(x, q, s, z, g, Out)
    _close(out, w4a16_matmul_plain(x, q, s, z, g, Out))
    assert not out[M // 2].any()
    if plan.splits > 1:
        assert torch.equal(out, w4a16_matmul(x, q, s, z, g, Out))


# what W4A16 leaves to its mma.sync kernel (chip_smoke.py's
# W4A16_MMA_GROUPS): g 1 at In 262 (quantize_stacked's group there), a K
# that is no multiple of 8 (262, g 131), a group below 16 (8); W4A8 runs
# g 1 and 8 on its mma.sync kernel too, 131 on split steps
@pytest.mark.parametrize("M", [1, 64, 300])
@pytest.mark.parametrize("In,Out,g", [(262, 1000, 1), (262, 1000, 131), (2880, 1000, 8)])
def test_w4_mma_remainder_matches_plain(gen, In, Out, g, M):
    from scratchpad_tpu_torch.ops.quant.w4_matmul import w4a8_plan, w4a16_plan

    assert w4a16_plan(M, Out, In, g, Out) is None
    assert (w4a8_plan(M, Out, In, g, Out) is None) == (g < 32)
    q, s, z = _random_w4(In, Out, gen, g)
    x = _w4_rows(M, In, gen)
    y16 = w4a16_matmul(x, q, s, z, g, Out)
    _close(y16, w4a16_matmul_plain(x, q, s, z, g, Out))
    assert not y16[M // 2].any()
    x8, ax, gsum = quantize_rows_int8(x, g)
    y8 = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
    _close(y8, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
    assert not y8[M // 2].any()


@pytest.mark.parametrize("rows,splits", [(64, 1), (64, 8), (32, 4), (16, 3), (8, 32)])
def test_w4a8_matmul_with_plan_matches_plain(gen, rows, splits):
    """tools/gemm_ab.py's sweep of decode plans: another token tile or K
    split than the plan's own gives the product too."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import w4a8_decode_plan, w4a8_matmul_with_plan

    In, Out, M = 2048, 512, 64
    plan = w4a8_decode_plan(M, Out, In, rows, splits)
    assert plan.splits == splits
    q, s, z = _random_w4(In, Out, gen)
    x8, ax, gsum = quantize_rows_int8(_w4_rows(M, In, gen), 128)
    out = w4a8_matmul_with_plan(x8, ax, gsum, q, s, z, 128, Out, plan)
    _close(out, w4a8_matmul_plain(x8, ax, gsum, q, s, z, 128, Out))
    assert not out[M // 2].any()


@pytest.mark.parametrize("route", ["a8", "a16"])
@pytest.mark.parametrize("M", [1, 64, 200])
@pytest.mark.parametrize("In,Out,group", [(2048, 512, 128), (512, 256, 32), (224, 1000, 128), (2880, 640, 128)])
def test_w4a8_zero_points_outside_the_code_range(gen, In, Out, group, M, route):
    """quantize_stacked gives a group of one sign a zero point outside [0,
    15] and a constant column one of about -5e7: the kernels fold the rest
    at the group's end, W4A8 with gsum, W4A16 with the sum of x over the
    group (In 224: group 112, K not a multiple of 128, the last 64-deep
    block half zero-filled)."""
    rng = np.random.default_rng(In + M)
    w = rng.normal(size=(1, In, Out)).astype(np.float32) / np.sqrt(In)
    w[0, :group, :7] = np.abs(w[0, :group, :7]) + 0.01  # one group of one sign
    w[0, group:, 7:13] = -np.abs(w[0, group:, 7:13]) - 0.02
    w[0, :, 13] = 0.5  # constant
    ql = quantize_stacked(w, group)
    zero = ql.z.float() + 0
    assert bool(((zero < 0) | (zero > 15)).any())
    q, s, z = (t[0].cuda() for t in pack_w4(ql))
    g = ql.group_size
    x = _w4_rows(M, In, gen)
    if route == "a16":
        out = w4a16_matmul(x, q, s, z, g, Out)
        _close(out, w4a16_matmul_plain(x, q, s, z, g, Out))
        assert torch.equal(out, w4a16_matmul(x, q, s, z, g, Out))
    else:
        x8, ax, gsum = quantize_rows_int8(x, g)
        out = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
        _close(out, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
    assert not out[M // 2].any()


@pytest.mark.parametrize("M", [1, 64, 8192])
@pytest.mark.parametrize("In,g", [(2048, 128), (8192, 128), (2880, 120)])
def test_quantize_rows_is_bit_exact_at_model_shapes(gen, M, In, g):
    """The quantizer's launch shapes: a CTA a row (M 1, 64) and several
    rows a CTA (M 8192), at the 1B's widths and GPT-OSS's."""
    x = _w4_rows(M, In, gen) * 3.0
    out = quantize_rows_int8(x, g)
    ref = quantize_activations_plain(x, g)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# (active_adapters, slots the tokens take); pool adapter 3 is LoRA only
DELTA_LAYOUTS = {
    "one_slot": ([0, 2, 0, 0, 0, 0, 0, 0], [1]),
    "all_eight_mixed": ([0, 1, 2, 3, 4, 5, 6, 7], list(range(8))),
    "slot_with_no_tokens": ([0, 1, 2, 4, 0, 0, 0, 0], [0, 1, 3]),
    "lora_only_slot": ([0, 3, 0, 0, 0, 0, 0, 0], [0, 1]),
}


def _delta_case(T, In, Out, layout, gen, N=8, L=2):
    active, choices = DELTA_LAYOUTS[layout]
    dq = torch.randint(-127, 128, (N, L, In, Out), generator=gen, device="cuda", dtype=torch.int8)
    dq[0] = 0
    ds = torch.rand(N, L, Out, generator=gen, device="cuda") * 0.002
    has_delta = torch.tensor([0, 1, 1, 0, 1, 1, 1, 1], dtype=torch.int32, device="cuda")
    scaling = torch.linspace(0.5, 2.0, N, device="cuda")
    pick = torch.randint(0, len(choices), (T,), generator=gen, device="cuda")
    slots = torch.tensor(choices, dtype=torch.int32, device="cuda")[pick]
    x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
    act = torch.tensor(active, dtype=torch.int32, device="cuda")
    return out, (x, dq, ds, 1, act, has_delta, scaling, slots)


@pytest.mark.parametrize("layout", list(DELTA_LAYOUTS))
@pytest.mark.parametrize("T", [1, 7, 64, 300])
@pytest.mark.parametrize("In,Out", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)])
def test_delta_kernel_matches_plain(gen, T, In, Out, layout):
    """Llama-3.2-1B's projection shapes; the kernel's sums against the plain
    version's f32 sums on the delta slots' rows, the other rows bit-equal."""
    out0, args = _delta_case(T, In, Out, layout, gen)
    got = delta_matmul_grouped(out0.clone(), *args)
    ref = delta_matmul_grouped_plain(out0.float(), *args)
    x, dq, ds, layer, act, has_delta, scaling, slots = args
    touched = (slots > 0) & (has_delta[act[slots].long()] > 0)
    _close(got[touched], ref[touched])
    assert torch.equal(got[~touched], out0[~touched])


@pytest.mark.parametrize("layout", list(DELTA_LAYOUTS))
@pytest.mark.parametrize(
    "T,In,Out",
    [(T, In, Out) for T in (65, 129) for In, Out in [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]]
    + [(T, 2048, 1000) for T in (1, 64, 129)],
)
def test_delta_kernel_matches_plain_at_the_plan_edges(gen, T, In, Out, layout):
    """The Hopper kernel's row edges (64 | 65, 128 | 129) and an Out that no
    tile width divides (1000, its rows 8-byte aligned only)."""
    out0, args = _delta_case(T, In, Out, layout, gen)
    got = delta_matmul_grouped(out0.clone(), *args)
    ref = delta_matmul_grouped_plain(out0.float(), *args)
    x, dq, ds, layer, act, has_delta, scaling, slots = args
    touched = (slots > 0) & (has_delta[act[slots].long()] > 0)
    _close(got[touched], ref[touched])
    assert torch.equal(got[~touched], out0[~touched])


@pytest.mark.parametrize("T,In,Out", [(64, 2048, 512), (16, 2048, 2048), (64, 8192, 2048), (100, 2048, 512)])
def test_delta_split_k_is_bit_exact(gen, T, In, Out):
    """Two calls of a plan that splits K give the same bits."""
    from scratchpad_tpu_torch.ops.quant.w4_matmul import gemm_plan

    assert gemm_plan(T, Out, In, slots=7).splits > 1
    out0, args = _delta_case(T, In, Out, "all_eight_mixed", gen)
    a = delta_matmul_grouped(out0.clone(), *args)
    b = delta_matmul_grouped(out0.clone(), *args)
    assert torch.equal(a, b)


def test_delta_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    out, args = _delta_case(8, 256, 128, "one_slot", gen)
    x, dq, ds, layer, act, has_delta, scaling, slots = args
    with pytest.raises(TypeError):  # f32 activations
        delta_matmul_grouped(out, x.float(), *args[1:])
    with pytest.raises(ValueError):  # In not a multiple of 16
        delta_matmul_grouped(out, x[:, :120].contiguous(), dq[:, :, :120].contiguous(), *args[2:])
    with pytest.raises(ValueError):  # a layer past the pool
        delta_matmul_grouped(out, x, dq, ds, 2, act, has_delta, scaling, slots)
    with pytest.raises(TypeError):  # i64 slots
        delta_matmul_grouped(out, x, dq, ds, layer, act, has_delta, scaling, slots.long())
    with pytest.raises(ValueError):  # slots on the CPU
        delta_matmul_grouped(out, x, dq, ds, layer, act, has_delta, scaling, slots.cpu())


def test_delta_wrapper_refuses_an_out_it_cannot_copy(gen):
    out, args = _delta_case(8, 256, 124, "one_slot", gen)  # rows 4-byte aligned
    with pytest.raises(ValueError, match="multiple of 8"):
        delta_matmul_grouped(out, *args)


# ------------------------------------------------------------------
# the decode ablation probe (csrc/decode_ablate.cu) and the decode kernel's
# stage cuts (SPTPU_DECODE_STAGE), with the kernel-profiling tools


def _ulp_ok(out, ref):
    """bf16 ``out`` within one bf16 ulp of the plain version's bf16 ``ref``."""
    torch.cuda.synchronize()
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    return bool(((out.float() - r).abs() <= ulp).all())


def _aux_ok(aux, ref, mode):
    """m exact; l and the checksum within ATOL + 2**-12 |plain| (see
    ``aux_tolerance``)."""
    from scratchpad_tpu_torch.ops.attention.decode_ablate import aux_tolerance

    return bool(((aux - ref).abs() <= aux_tolerance(ref, mode, ATOL)).all())


def _ablate_case(lens, Hkv, G, Dp, gen, ps=16, CP=16):
    B = len(lens)
    P = max(max(-(-n // (CP * ps)), 1) for n in lens) * CP
    pages = B * P + 1
    kv = torch.randn(pages, ps, 2 * Hkv, Dp, generator=gen, device="cuda").to(torch.bfloat16)
    pt = torch.randint(0, pages, (B, P), generator=gen, device="cuda", dtype=torch.int32)
    q = torch.randn(B, Hkv * G, Dp, generator=gen, device="cuda").to(torch.bfloat16)
    return q, kv, pt, torch.tensor(lens, dtype=torch.int32, device="cuda")


# lengths 0 and 1, page and chunk edges (192, 256, 257), 4 chunks (1000);
# 16 chunks (4096) and one token short of them, the cross-chunk rescale
ABLATE_LENS = {"edges": [1000, 0, 1, 192, 256, 257, 17], "ctx4096": [4096, 4095, 1, 0]}


@pytest.mark.parametrize("lens", list(ABLATE_LENS), ids=list(ABLATE_LENS))
@pytest.mark.parametrize("mode", ["dma_only", "reshape_only", "sdot_only", "no_pv", "full"])
@pytest.mark.parametrize(
    "G,Dp", [(1, 64), (1, 128), (2, 64), (2, 128), (3, 64), (4, 64), (3, 128), (4, 128), (8, 64), (8, 128)]
)
def test_decode_ablate_kernel_matches_plain(gen, mode, G, Dp, lens):
    from scratchpad_tpu_torch.ops.attention import decode_ablate, decode_ablate_plain

    q, kv, pt, lens = _ablate_case(ABLATE_LENS[lens], 2, G, Dp, gen)
    out, aux = decode_ablate(q, kv, pt, lens, mode)
    ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode)
    assert _ulp_ok(out, ref_out) and _aux_ok(aux, ref_aux, mode)
    again, again_aux = decode_ablate(q, kv, pt, lens, mode)  # the counters were left at zero
    assert torch.equal(again, out) and torch.equal(again_aux, aux)


def test_decode_ablate_refuses_a_narrow_table(gen):
    from scratchpad_tpu_torch.ops.attention import decode_ablate

    q, kv, pt, lens = _ablate_case([300, 20], 2, 4, 64, gen)  # 300 tokens: 2 chunks, 32 entries
    with pytest.raises(ValueError, match="entries a row"):
        decode_ablate(q, kv, pt[:, :16].contiguous(), lens, "full")
    # a caller that understates the longest row: the kernel reads nothing past
    # the table and gives that row NaN
    out, aux = decode_ablate(q, kv, pt[:, :16].contiguous(), lens, "full", max_seq_len=20)
    torch.cuda.synchronize()
    assert bool(aux[0].isnan().all()) and bool(out[0].float().isnan().all())
    assert bool(torch.isfinite(aux[1]).all())


@pytest.mark.parametrize("stage", [1, 2, 3, 5])
@pytest.mark.parametrize("G,D", [(4, 64), (3, 128), (4, 128)])
def test_decode_stage_cuts_match_their_plain_functions(gen, stage, G, D):
    from scratchpad_tpu_torch.ops.attention.gqa_decode import (
        paged_decode_attention_stage,
        paged_decode_attention_stage_plain,
    )

    k, v, pt = _pool([300, 0, 17, 4096], 8, D, 16, gen)
    q = torch.randn(4, 8 * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor([300, 0, 17, 4096], dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(D)
    _close(paged_decode_attention_stage(stage, q, k, v, pt, seq, scale),
           paged_decode_attention_stage_plain(stage, q, k, v, pt, seq, scale))


def test_profiling_tools_run_on_the_card(gen, tmp_path):
    """Each tool's main at a small size on the card, and analyze_trace on a
    trace the profiler just wrote."""
    from torch.profiler import ProfilerActivity, profile

    from scratchpad_tpu_torch.tools import (
        analyze_trace,
        decode_ablate as ablate_tool,
        decode_kernel_bench,
        prof_attn,
        w4_kernel_bench,
    )

    rows = ablate_tool.main(["--batch", "8", "--layers", "2", "--iters", "2", "--stage-batch", "4",
                             "--stage-ctx", "512", "--stage-models", "1b"])
    assert all(r["ms"] > 0 for r in rows) and len(rows) == 5 + 5  # modes, then stages 1 to 5
    assert [r["out"] for r in rows[:5]][3:] == [192.0, 192.0]  # zeros pool: m 0, l = ctx
    assert prof_attn.main(["--cases", "t=8:64", "--layers", "2", "--iters", "2"])[0]["ms"] > 0
    assert decode_kernel_bench.main(["llama-3.2-1b", "64", "8", "--iters", "5"])["us_per_call"] > 0
    r = w4_kernel_bench.main(["--shape", "a:512:256", "--bs", "4", "--iters", "2", "--route", "a8"])
    assert r[0]["us"] > 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_attn.main(["--cases", "t=8:64", "--layers", "2", "--iters", "1"])
        torch.cuda.synchronize()
    path = tmp_path / "trace.json.gz"
    prof.export_chrome_trace(str(path))
    r = analyze_trace.rollup(analyze_trace.load_events(path))
    assert r["by_category"].get("port kernel", 0) > 0 and 0 < r["busy_us"] <= r["span_us"]


# ------------------------------------------------------------ attention sinks

# (name, sinks of GPT-OSS's 64 query heads): N(0, 2^2), far below every
# score, far above every score (the softmax's max is the sink's)
SINK_KINDS = ["normal", "minus8", "plus100"]


def _sink_values(kind, Hq, gen):
    if kind == "normal":
        return 2.0 * torch.randn(Hq, generator=gen, device="cuda")
    return torch.full((Hq,), -8.0 if kind == "minus8" else 100.0, device="cuda")


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("sink", SINK_KINDS)
@pytest.mark.parametrize("lens", [[4096], [1, 0, 200, 130], [300, 0] * 32])
def test_decode_kernel_with_sinks_matches_plain(gen, kind, window, sink, lens):
    """GPT-OSS's decode (Hkv 8, G 8, D 64): one row split across the card, a
    short batch and B 64, rows of length 0; a split call bit-equal on a
    repeat (``_decode_checked``)."""
    Hkv, G, D = 8, 8, 64
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sinks = _sink_values(sink, Hkv * G, gen)
    scale = 1 / math.sqrt(D)
    if ks is None:
        out = paged_decode_attention(q, k, v, pt, seq, scale, None, window, sinks)
    else:
        out = paged_decode_attention_quant(q, k, v, ks, vs, pt, seq, scale, None, window, sinks)
    ref = paged_decode_attention_plain(q.float(), k, v, pt, seq, scale, ks, vs, None, window, sinks)
    _close(out, ref)
    assert bool(torch.isfinite(out.float()).all()) and bool((out[seq == 0] == 0).all())
    again = (paged_decode_attention(q, k, v, pt, seq, scale, None, window, sinks) if ks is None
             else paged_decode_attention_quant(q, k, v, ks, vs, pt, seq, scale, None, window, sinks))
    assert torch.equal(out, again)


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("sink", SINK_KINDS)
def test_extend_kernel_with_sinks_matches_plain(gen, kind, window, sink):
    """GPT-OSS's extend (Hkv 8, G 8, D 64): mixed chunks, a cached prefix,
    padding tokens exact zeros."""
    q, k, v, pt, kv_lens, cu = _extend_case(8, 64, 8, gen)
    k, v, ks, vs = _pages(kind, k, v)
    sinks = _sink_values(sink, 64, gen)
    if ks is None:
        out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.125, None, window, sinks)
    else:
        out = paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, 0.125, None, window, sinks)
    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 0.125, ks, vs, None, window,
                                       sinks)
    _close(out, ref)
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_sinks_change_the_output_and_are_checked(gen):
    """The sinks branch is live in both kernels (N(0, 2^2) sinks move the
    outputs), and a sinks tensor the kernels do not take is refused."""
    q, k, v, pt, kv_lens, cu = _extend_case(8, 64, 8, gen)
    sinks = _sink_values("normal", 64, gen)
    a = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.125, sinks=sinks)
    b = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.125)
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    qd = q[:4].contiguous()
    seq = torch.tensor([100, 600, 33, 250], dtype=torch.int32, device="cuda")
    pt4 = pt[[0, 1, 2, 4]].contiguous()
    a = paged_decode_attention(qd, k, v, pt4, seq, 0.125, sinks=sinks)
    b = paged_decode_attention(qd, k, v, pt4, seq, 0.125)
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    for bad in (sinks.to(torch.bfloat16), sinks[:32], sinks.cpu()):
        with pytest.raises((ValueError, RuntimeError)):
            paged_decode_attention(qd, k, v, pt4, seq, 0.125, sinks=bad)


# Llama-4's chunked attention: Scout's grouping (G 5) and G 4 at head_dim
# 128; chunks on a page edge (16) and inside a page (100), 1000, and
# Scout's 8192
CHUNK_SIZES = [16, 100, 1000, 8192]


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("G", [4, 5])
@pytest.mark.parametrize("C", CHUNK_SIZES)
@pytest.mark.parametrize("batch", ["edges", "split"])
def test_decode_kernel_with_chunk_matches_plain(gen, kind, G, C, batch):
    """Rows a token before, on and after a chunk edge, past two chunks and
    of length 0 ("edges"), or one row of 2C + 17 split across the card
    ("split", bit-equal on a repeat): the kernel reads only the query's
    chunk, and a split wholly below its start adds nothing."""
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, D = 8, 128
    lens = [C - 1, C, C + 1, 2 * C + 17, 0] if batch == "edges" else [2 * C + 17]
    k, v, pt = _pool(lens, Hkv, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(D)

    def run():
        if ks is None:
            return paged_decode_attention(q, k, v, pt, seq, scale, chunk_size=C)
        return paged_decode_attention_quant(q, k, v, ks, vs, pt, seq, scale, chunk_size=C)

    out = run()
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, scale, ks, vs, chunk_size=C))
    assert bool((out[seq == 0] == 0).all())
    if decode_plan(len(lens), Hkv, pt.shape[1], D, G).splits > 1:
        assert torch.equal(out, run())


@pytest.mark.parametrize("kind", list(CODE_DTYPES))
@pytest.mark.parametrize("G", [4, 5])
@pytest.mark.parametrize("C", CHUNK_SIZES)
def test_extend_kernel_with_chunk_matches_plain(gen, kind, G, C):
    """Query tiles that straddle a chunk edge (each row masked by its own
    chunk's start): a prompt across the edge, a chunk after a cached prefix
    that starts a token before it, a one-token row past two chunks, and
    padding tokens (exact zeros)."""
    Hkv, D = 8, 128
    chunks = [(C + 150, C + 150), (300, C + 299), (1, 2 * C + 17)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    k, v, ks, vs = _pages(kind, k, v)
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor([c[0] for c in chunks], device="cuda"), 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    q = torch.randn(int(cu[-1]) + 29, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    if ks is None:
        out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, chunk_size=C)
    else:
        out = paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, 0.1, chunk_size=C)
    _close(out, paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 0.1, ks, vs, chunk_size=C))
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_chunk_changes_the_output_and_is_checked(gen):
    """The chunk branch is live in both kernels, and a call with a window
    and a chunk is refused."""
    q, k, v, pt, kv_lens, cu = _extend_case(8, 128, 5, gen)
    a = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, chunk_size=64)
    b = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1)
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    qd = q[:4].contiguous()
    seq = torch.tensor([100, 600, 33, 250], dtype=torch.int32, device="cuda")
    pt4 = pt[[0, 1, 2, 4]].contiguous()
    a = paged_decode_attention(qd, k, v, pt4, seq, 0.1, chunk_size=64)
    b = paged_decode_attention(qd, k, v, pt4, seq, 0.1)
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(qd, k, v, pt4, seq, 0.1, sliding_window=128, chunk_size=64)
    with pytest.raises(ValueError, match="window"):
        paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, sliding_window=128, chunk_size=64)


def test_custom_logit_processors_on_the_card(gen):
    """``chip_smoke.phase_custom`` on a tiny Llama in bf16, overlap on."""
    import chip_smoke
    from scratchpad_tpu_torch.config import ServerArgs
    from scratchpad_tpu_torch.config.model_config import get_preset
    from scratchpad_tpu_torch.server.engine import Engine

    eng = Engine(ServerArgs(random_weights=True, dtype="bfloat16", page_size=16, max_total_tokens=8192),
                 model_config=get_preset("tiny-debug", head_dim=64))
    chip_smoke.FAILURES.clear()
    out = chip_smoke.phase_custom(eng, "tiny")
    assert chip_smoke.FAILURES == []
    assert out["pipelined_windows"] > 0 and out["windows_with_processors"] == 0 and out["in_place_isolated"]


def test_deepseek_latent_attention_matches_expanded_form(gen):
    """``chip_smoke.phase_engine`` on DeepSeek-V2-Lite's config at narrow
    widths (4 layers, 16 experts top 4, 2 shared) in bf16: every request
    finishes with a radix hit, no attention kernel launches, and the logits
    hold against HF's expanded form (``ExpandedMla``) at the kernel path's
    routing, with the rope term moving them by ``ROPE_MOVE`` times that."""
    import chip_smoke
    from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine

    cfg = ModelConfig.from_hf_config(dict(
        chip_smoke.DEEPSEEK_V2_LITE, vocab_size=4096, hidden_size=512, intermediate_size=1024,
        moe_intermediate_size=128, num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=8,
        n_routed_experts=16, num_experts_per_tok=4, max_position_embeddings=16384))
    eng = Engine(ServerArgs(random_weights=True, dtype="bfloat16", page_size=16, max_total_tokens=16384),
                 model_config=cfg)
    assert eng.scheduler.runner.kv_bytes_per_token() == 4 * 576 * 2
    chip_smoke.FAILURES.clear()
    out = chip_smoke.phase_engine(eng, "deepseek-v2-lite", requests=chip_smoke.UNTIMED_REQUESTS)
    assert chip_smoke.FAILURES == []
    assert out["worst_logit_rel"] <= chip_smoke.LOGIT_RTOL["deepseek-v2-lite"]
    assert out["rope_move_min"] >= chip_smoke.ROPE_MOVE * out["worst_logit_rel"]


def test_mllama_phase_on_the_card(gen):
    """``chip_smoke.phase_mllama`` on Llama-3.2-11B-Vision's structure at
    narrow widths (10 decoder layers, cross layers 3 and 8, hidden 1024 with
    8 heads of 128 over 2 kv heads; a tower of 4 + 2 layers of 128 at 112
    px) in bf16, two cross slots: every request finishes, rows 3 and 1
    launch exactly once a self layer and forward (8, the cross layers
    none), at most two images share a forward, the chat prompt with another
    image or none reuses no page of the chat request while its own image
    again reuses the prompt past it, the logits hold against the plain path
    and another image moves them by ``IMAGE_MOVE`` times that, and the cross
    layer holds against its unblocked reference."""
    import chip_smoke
    from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine

    full = chip_smoke.LLAMA32_11B_VISION
    cfg = ModelConfig.from_hf_config(dict(
        full, text_config=dict(full["text_config"], num_hidden_layers=10, hidden_size=1024,
                               intermediate_size=2048, num_attention_heads=8, num_key_value_heads=2),
        vision_config=dict(full["vision_config"], hidden_size=128, attention_heads=2, num_hidden_layers=4,
                           num_global_layers=2, image_size=112, intermediate_size=256,
                           intermediate_layers_indices=[1, 3], vision_output_dim=384)))
    eng = Engine(ServerArgs(random_weights=True, dtype="bfloat16", page_size=16, max_total_tokens=16384,
                            cross_kv_slots=chip_smoke.MLLAMA_SLOTS), model_config=cfg)
    chip_smoke.FAILURES.clear()
    out = chip_smoke.phase_mllama(eng)
    assert chip_smoke.FAILURES == []
    assert out["self_layers"] == 8
    assert set(out["launches_per_forward"].values()) == {8.0}
    assert 0 < out["images_at_once"] <= chip_smoke.MLLAMA_SLOTS
    assert out["worst_logit_rel"] <= chip_smoke.LOGIT_RTOL["llama-3.2-11b-vision"]
    assert out["image_move"] >= chip_smoke.IMAGE_MOVE * out["worst_logit_rel"]
    other, text_only, same = out["cached_tokens"]
    assert other == text_only == 0 < same
    assert out["cross_err"] <= chip_smoke.CROSS_RTOL
    assert out["tower_ms"] > 0 and out["cross_gib"] > 0 and "NVIDIA" in out["card"]
    eng.scheduler.check_memory_leak()


# bidirectional image spans (rows 3m and 3qm, Gemma 3 multimodal): (q_len,
# kv_len) a row and its spans, absolute [s0, s1); a span across several
# 64-row query tiles, two spans in a row, a span after a cached prefix, a
# span longer than the window of 128, a row without spans, padding rows
SPAN_ROWS = [
    ((700, 700), [(10, 266), (300, 556)]),
    ((400, 1000), [(650, 906), (0, 0)]),
    ((90, 90), [(0, 0), (0, 0)]),
    ((1, 33), [(0, 0), (0, 0)]),
    ((0, 0), [(0, 0), (0, 0)]),
]


def _span_case(Hkv, D, G, gen):
    chunks = [r[0] for r in SPAN_ROWS]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, 16, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    spans = torch.tensor([r[1] for r in SPAN_ROWS], dtype=torch.int32, device="cuda")
    return q, k, v, pt, kv_lens, cu, spans


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("D, G", [(256, 2), (256, 4), (128, 6), (128, 1), (64, 4)])
def test_extend_kernel_with_spans_matches_plain(gen, kind, window, D, G):
    """Rows 3m and 3qm against the plain version at Gemma 3's D 256 (G 2
    and 4), Qwen2-VL's and LLaVA's D 128 shapes and D 64; padding tokens
    exact zeros; the spans move the rows inside them."""
    q, k, v, pt, kv_lens, cu, spans = _span_case(2, D, G, gen)
    ks = vs = None
    if kind != "bf16":
        k, v, ks, vs = _quantized(k, v, torch.int8 if kind == "int8" else torch.float8_e4m3fn)
    kw = dict(sliding_window=window, mm_spans=spans)
    if ks is None:
        out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, **kw)
        causal = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, sliding_window=window)
    else:
        out = paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, 0.1, **kw)
        causal = paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, 0.1, sliding_window=window)
    _close(out, paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 0.1, ks, vs, **kw))
    assert bool((out[int(cu[-1]) :] == 0).all())
    assert float((out.float() - causal.float()).abs().max()) > 1e-2


def test_spans_with_a_chunk_are_refused(gen):
    q, k, v, pt, kv_lens, cu, spans = _span_case(2, 128, 4, gen)
    with pytest.raises(ValueError, match="chunk"):
        paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1, chunk_size=64, mm_spans=spans)


@pytest.mark.parametrize(
    "label, hf",
    [
        ("gemma-2-2b-tp2", dict(architectures=["Gemma2ForCausalLM"], hidden_size=512, intermediate_size=1024,
                                num_attention_heads=8, num_key_value_heads=4, head_dim=256,
                                query_pre_attn_scalar=256, sliding_window=128, attn_logit_softcapping=50.0,
                                final_logit_softcapping=30.0, tie_word_embeddings=True)),
        ("gpt-oss-20b-tp2", dict(architectures=["GptOssForCausalLM"], hidden_size=512, intermediate_size=256,
                                 num_attention_heads=16, num_key_value_heads=4, head_dim=64,
                                 num_local_experts=8, num_experts_per_tok=2, sliding_window=128,
                                 layer_types=["sliding_attention", "full_attention"] * 2, attention_bias=True)),
        ("qwen3-30b-a3b-tp2", dict(architectures=["Qwen3MoeForCausalLM"], hidden_size=512,
                                          moe_intermediate_size=128, num_attention_heads=8,
                                          num_key_value_heads=4, head_dim=128, num_experts=16,
                                          num_experts_per_tok=4, norm_topk_prob=True)),
        ("llama4-scout-tp2", dict(architectures=["Llama4ForCausalLM"], hidden_size=512, intermediate_size=256,
                                  intermediate_size_mlp=512, num_attention_heads=10, num_key_value_heads=2,
                                  head_dim=128, num_local_experts=4, num_experts_per_tok=1, use_qk_norm=True,
                                  attention_chunk_size=256, attn_temperature_tuning=True, floor_scale=256,
                                  attn_scale=0.1)),
        ("deepseek-v2-lite-tp2", dict(architectures=["DeepseekV2ForCausalLM"], hidden_size=512,
                                      intermediate_size=1024, moe_intermediate_size=128, num_attention_heads=8,
                                      num_key_value_heads=8, kv_lora_rank=128, qk_nope_head_dim=64,
                                      qk_rope_head_dim=32, v_head_dim=64, n_routed_experts=16,
                                      num_experts_per_tok=4, n_shared_experts=2, first_k_dense_replace=1,
                                      n_group=1, topk_group=1)),
    ],
    ids=["gemma2", "gpt-oss", "qwen3-moe-pallas", "llama4", "deepseek"],
)
def test_tp_families_phase_on_the_card(label, hf, gen):
    """``chip_smoke.phase_tp_families`` on one family of ``TP_FAMILIES`` at
    narrow widths (4 layers, bf16, vocabulary 4096): the tp 2 engines (two
    ranks on cuda:0 over gloo) held to the tp 1 engine beside them: no
    check fails, each attention kernel of the configuration's path launches
    once a layer a forward on every rank (none for MLA), and the
    collectives a forward are ``per_layer`` a layer plus two."""
    import chip_smoke
    from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine

    cfg = ModelConfig.from_hf_config(dict(hf, vocab_size=4096, num_hidden_layers=4, max_position_embeddings=16384,
                                          rms_norm_eps=1e-6, rope_theta=10000.0))
    ref_label, _, _, per_layer = chip_smoke.TP_FAMILIES[label]
    eng = Engine(ServerArgs(random_weights=True, dtype="bfloat16", page_size=16, max_total_tokens=16384),
                 model_config=cfg)
    chip_smoke.FAILURES.clear()
    out = chip_smoke.phase_tp_families(eng, ref_label, {})[label]
    assert chip_smoke.FAILURES == []
    assert out["collectives_per_forward"] == per_layer * 4 + 2
    assert all(n == [4.0, 4.0] for n in out["launches_per_forward"].values())
    assert bool(out["launches_per_forward"]) != cfg.is_mla
    assert out["worst_logit_rel"] <= chip_smoke.LOGIT_RTOL[label]
