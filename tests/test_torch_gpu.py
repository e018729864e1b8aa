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
context gives the kernel's no-window output bit for bit. The decode
ablation probe's ``out`` must lie within one bf16 ulp of its plain
version's (both round the same f32 statistic to bf16 once), its ``aux``
within ``aux_tolerance`` (m exact, the rest ATOL + 2**-12 |plain|); the
decode kernel's stage cuts are held to their plain functions at ATOL + RTOL
|plain|, and the profiling tools run at small sizes.
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


def _random_w4(In, Out, gen, g=128):
    """Random packed codes with bf16 scales in [0.005, 0.02) and zero points
    0..15 (stored minus 8), as chip_smoke.py's ``random_w4``."""
    q = torch.randint(0, 256, (Out, In // 2), generator=gen, device="cuda", dtype=torch.uint8)
    s = (torch.rand(In // g, Out, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
    z = (torch.randint(0, 16, (In // g, Out), generator=gen, device="cuda") - 8).to(torch.bfloat16)
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


@pytest.mark.parametrize("mode", ["dma_only", "reshape_only", "sdot_only", "no_pv", "full"])
@pytest.mark.parametrize("G,Dp", [(3, 64), (4, 64), (3, 128), (4, 128)])
def test_decode_ablate_kernel_matches_plain(gen, mode, G, Dp):
    from scratchpad_tpu_torch.ops.attention import decode_ablate, decode_ablate_plain

    # lengths 0 and 1, page and chunk edges (192, 256, 257), 4 chunks (1000)
    q, kv, pt, lens = _ablate_case([1000, 0, 1, 192, 256, 257, 17], 2, G, Dp, gen)
    out, aux = decode_ablate(q, kv, pt, lens, mode)
    ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode)
    assert _ulp_ok(out, ref_out) and _aux_ok(aux, ref_aux, mode)


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
