"""The port's int8 and fp8 (e4m3) paged KV against the JAX package's, on the CPU.

- ``quantize_rows`` and ``write_kv`` give the JAX package's codes and scales
  bit for bit; the JAX pool comes over through ``kv_cache_from_jax``.
- Decode and extend attention over identical 8-bit pages (the JAX pool,
  converted): the port's plain versions against the JAX package's Pallas
  decode kernel in interpret mode, its XLA backend, and its quantized extend
  (``dequant_pages`` + the bundled kernel's reference). Tolerance 2e-4, the
  JAX package's own for these paths: the Pallas kernel folds the scales out
  of its dots, the others dequantize first, all in f32.
- The model and the engine: tiny-debug in f32 with int8 and fp8 KV, and W4A8
  weights with int8 KV, against the JAX package at the same settings (its XLA
  backend on the CPU). Logits within 1e-4 of max |logit|; the same greedy
  tokens through ``Engine.generate``, with a radix hit and a chunked prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.ragged_paged_attention import ref_ragged_paged_attention

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.ragged_backend import dequant_pages
from scratchpad_tpu.ops.attention.xla_backend import (
    _quantize_rows,
    decode_attention_xla,
    extend_attention_xla,
)
from scratchpad_tpu.ops.attention.xla_backend import write_kv as jax_write_kv
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import kv_cache_from_jax, params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.ops.attention import (
    attention_ragged,
    decode_attention_gqa,
    paged_decode_attention_quant,
    paged_extend_attention_quant,
    quantize_rows,
    write_kv,
)
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_attention import LAYER, LAYERS, _case, _decode_metas
from test_torch_engine import ARGS, _greedy_tokens_match
from test_torch_model import VARIANTS, Pair

TOL = dict(rtol=2e-4, atol=2e-4)
CODES = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
KV_DTYPES = list(CODES)


def _edge_rows(kv_dtype: str) -> np.ndarray:
    """[rows, 16] f32 rows that probe every rounding edge of the quantizer."""
    limit = 127.0 if kv_dtype == "int8" else 448.0
    rows = [np.zeros(16)]  # all zeros: the 1e-8 floor of the scale
    # amax / limit just under a bf16 rounding midpoint above 1: the scale
    # rounds down to 1.0, so |x / scale| reaches limit * (1 + 2**-8) - eps
    # (449.7 for e4m3, 127.49 for int8)
    for top in (limit * 1.0039, limit * 1.0020, limit * 0.9999):
        rows.append(np.linspace(-top, top, 16))
    # scale exactly 1 (amax == limit): values on the round-half-even edges
    halves = (
        [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -125.5, 3.5, 4.5, 0.49999997, 0.50000006]
        if kv_dtype == "int8"
        # e4m3 midpoints: 1.0625 (-> 1), 1.1875 (-> 1.25), 17 (-> 16), 19 (-> 20)
        else [1.0625, 1.1875, 17.0, 19.0, -1.0625, -19.0, 232.0, 240.0, 0.0, 3.25, 3.75]
    )
    rows.append(np.array([limit] + halves + [0.0] * (15 - len(halves))))
    # the 2**-6 flush edge of e4m3 at scale 1, and the int8 grid near it
    e = 2.0**-6
    rows.append(np.array([limit, e, -e, e * (1 - 2**-20), -e * (1 - 2**-20), e * 1.5,
                          e / 2, e * 0.99, -e * 1.01, 2**-7, 2**-9, -2**-10, 1e-30, 0, 0, 0]))
    rng = np.random.default_rng(0)
    rows += list(rng.normal(size=(6, 16)) * rng.uniform(1e-3, 1e3, (6, 1)))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantize_rows_bit_for_bit(kv_dtype):
    """The port's quantizer returns the JAX package's codes and bf16 scales to
    the bit, on rows at each of its edges."""
    x = _edge_rows(kv_dtype).reshape(4, -1, 16)  # [T, H, D]
    tdt, jdt = CODES[kv_dtype]
    codes, scale = quantize_rows(torch.from_numpy(x), tdt)
    jcodes, jscale = _quantize_rows(jnp.asarray(x), jdt)
    assert codes.dtype == tdt and scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(), np.asarray(jcodes).view(np.uint8))
    np.testing.assert_array_equal(scale.float().numpy(), np.asarray(jscale, np.float32))
    # the rows past the e4m3 maximum land on 448, not NaN; nothing sub-normal
    deq = codes.float()
    assert bool(torch.isfinite(deq).all())
    if kv_dtype == "fp8":
        assert float(deq.abs().max()) == 448.0
        nz = deq[deq != 0].abs()
        assert float(nz.min()) >= 2.0**-6


def _jax_pool(num_pages, ps, Hkv, head_dim, kv_dtype):
    return jax_create_kv_cache(
        JaxKVConfig(
            num_layers=LAYERS, num_pages=num_pages, page_size=ps, num_kv_heads=Hkv,
            head_dim=head_dim, dtype=jnp.float32, quantized=True,
            quant_dtype=CODES[kv_dtype][1],
        )
    )


def _kv(rng, n, Hkv, D):
    """K and V from different distributions, so that a converter that swaps
    their scales cannot pass."""
    k = (rng.normal(size=(n, Hkv, D)) * 7.3).astype(np.float32)
    v = (rng.normal(size=(n, Hkv, D)) * 0.02).astype(np.float32)
    return k, v


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("jax_head_dim", [32, 128])  # the JAX pool lane-padded or not
def test_write_kv_matches_jax(kv_dtype, jax_head_dim):
    """The same K/V written by each package's ``write_kv`` at scattered slots
    of one layer: the JAX pool, converted by ``kv_cache_from_jax``, holds the
    port pool's codes and scales to the bit, and every other slot and layer
    stays zero."""
    Hkv, D, ps = 2, 32, 4
    rng, num_pages, _, loc, _, _ = _case([7, 10, 3], Hkv, D, ps, seed=4)
    k, v = _kv(rng, len(loc), Hkv, D)
    jkv = jax_write_kv(
        _jax_pool(num_pages, ps, Hkv, jax_head_dim, kv_dtype),
        jnp.asarray(k), jnp.asarray(v), LAYER, jnp.asarray(loc),
    )
    tkv = create_kv_cache(
        KVCacheConfig(LAYERS, num_pages, ps, Hkv, D, torch.float32, quantized=True,
                      quant_dtype=CODES[kv_dtype][0]),
        torch.device("cpu"),
    )
    write_kv(tkv, torch.from_numpy(k), torch.from_numpy(v), LAYER, torch.from_numpy(loc).long())
    conv = kv_cache_from_jax(np.asarray(jkv.kv), np.asarray(jkv.scale), LAYERS, D)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(tkv, name), getattr(conv, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                           b.view(torch.uint8) if b.element_size() == 1 else b), name
    assert float(tkv.k_scale.float().max()) > 100 * float(tkv.v_scale.float().max())
    untouched = torch.ones(num_pages * ps, dtype=torch.bool)
    untouched[torch.from_numpy(loc).long()] = False
    _, _, ks, _ = tkv.layer(LAYER)
    assert not ks.reshape(-1, Hkv)[untouched].float().any()
    assert not tkv.k[1 - LAYER].view(torch.uint8).any() and not tkv.v_scale[1 - LAYER].float().any()


def _quant_pools(kv_lens, Hkv, D, ps, kv_dtype, jax_head_dim, seed):
    """Random K/V written into a JAX 8-bit pool and converted for the port:
    both sides attend over the same codes and scales."""
    rng, num_pages, pt, loc, _, _ = _case(kv_lens, Hkv, D, ps, seed)
    k, v = _kv(rng, len(loc), Hkv, D)
    jkv = jax_write_kv(
        _jax_pool(num_pages, ps, Hkv, jax_head_dim, kv_dtype),
        jnp.asarray(k), jnp.asarray(v), LAYER, jnp.asarray(loc),
    )
    tkv = kv_cache_from_jax(np.asarray(jkv.kv), np.asarray(jkv.scale), LAYERS, D)
    return rng, num_pages, pt, jkv, tkv


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize(
    "seq_lens, Hq, Hkv, D, ps",
    [
        # G = 3 (Llama-3.2-3B's grouping), a padding row; the JAX package's
        # grouped kernel (every page table inside one 16-page chunk)
        ([37, 0, 120, 250], 6, 2, 64, 16),
        # G = 1, head_dim 128, one sequence over several chunks
        ([700], 4, 4, 128, 16),
        # G = 4, page size 4, a padding row
        ([45, 12, 0], 8, 2, 64, 4),
    ],
)
def test_quant_decode_matches_jax(kv_dtype, seq_lens, Hq, Hkv, D, ps):
    seq_lens = np.asarray(seq_lens, np.int32)
    rng, _, pt, jkv, tkv = _quant_pools(
        seq_lens.tolist(), Hkv, D, ps, kv_dtype, 128, seed=int(seq_lens.sum())
    )
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    jm, tm = _decode_metas(pt, seq_lens)
    qj = jnp.asarray(q)
    ref_gqa = np.asarray(jax_gqa(qj, jkv, LAYER, jm, page_size=ps, sm_scale=scale))
    ref_xla = np.array(decode_attention_xla(qj, jkv, LAYER, jm, page_size=ps, sm_scale=scale))
    before = paged_decode_attention_quant.launches
    out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale).numpy()
    assert paged_decode_attention_quant.launches == before  # the plain version, on the CPU
    pad = seq_lens == 0
    ref_xla[pad] = 0.0  # the XLA reference leaves padding rows undefined
    np.testing.assert_allclose(out, ref_gqa, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)
    assert np.all(out[pad] == 0.0)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize(
    "chunks, Hq, Hkv, D, ps, T_pad",
    [
        # a fresh prompt, a chunk after a cached prefix, a one-token row, padding
        ([(9, 9), (6, 30), (1, 13)], 6, 2, 32, 4, 20),
        # head_dim 64, G = 4: a chunked prefill's second chunk beside a fresh prompt
        ([(16, 48), (20, 20)], 16, 4, 64, 16, 36),
    ],
)
def test_quant_extend_matches_jax(kv_dtype, chunks, Hq, Hkv, D, ps, T_pad):
    kv_lens = np.asarray([c[1] for c in chunks], np.int32)
    rng, num_pages, pt, jkv, tkv = _quant_pools(kv_lens.tolist(), Hkv, D, ps, kv_dtype, D, seed=D)
    q_lens = np.asarray([c[0] for c in chunks], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    n_real, B = int(cu[-1]), len(chunks)
    T = max(T_pad, n_real)
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
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
    tm = ForwardMeta(
        mode=ForwardMode.EXTEND, tokens=torch.zeros(T, dtype=torch.long),
        positions=torch.from_numpy(pos).long(), out_cache_loc=torch.zeros(T, dtype=torch.long),
        req_indices=torch.from_numpy(req).long(), page_table=torch.from_numpy(pt),
        seq_lens=torch.from_numpy(kv_lens), extend_lens=torch.from_numpy(q_lens),
        last_token_idx=torch.from_numpy(cu[1:] - 1).long(), cu_q_lens=torch.from_numpy(cu),
    )
    qj = jnp.asarray(q)
    ref_xla = np.asarray(extend_attention_xla(qj, jkv, LAYER, jm, page_size=ps, sm_scale=scale))
    # the JAX package's quantized extend: the batch's pages dequantized into
    # a scratch pool, then the bundled ragged kernel (its reference on the CPU)
    scratch, new_pt = dequant_pages(jkv, jnp.int32(LAYER), jm.page_table, jnp.float32)
    ref_ragged = np.asarray(
        ref_ragged_paged_attention(
            qj * scale, scratch, jnp.asarray(kv_lens), new_pt, jnp.asarray(cu),
            jnp.asarray([B], jnp.int32), sm_scale=1.0,
        )
    )
    before = paged_extend_attention_quant.launches
    out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale).numpy()
    assert paged_extend_attention_quant.launches == before
    np.testing.assert_allclose(out[:n_real], ref_xla[:n_real], **TOL)
    np.testing.assert_allclose(out[:n_real], ref_ragged[:n_real], **TOL)
    assert np.all(out[n_real:] == 0.0)  # padding tokens come out as zeros


def test_kv_cache_from_jax_rejects_a_mismatched_pool():
    kv = np.zeros((2 * 5, 4, 4, 32), np.int8)
    with pytest.raises(ValueError):  # 10 pages do not split into 3 layers
        kv_cache_from_jax(kv, np.zeros((10, 4, 128), np.float32), 3, 32)
    with pytest.raises(ValueError):  # head_dim past the stored lanes
        kv_cache_from_jax(kv, np.zeros((10, 4, 128), np.float32), 2, 64)
    with pytest.raises(ValueError):  # fewer scale lanes than 2 Hkv
        kv_cache_from_jax(kv, np.zeros((10, 4, 2), np.float32), 2, 32)


# ------------------------------------------------------ the model and engine


def _logits_rel_check(pair, seed):
    """One extend (a fresh prompt beside another), a chunk after the cached
    prefix and two decode steps: the port's logits within 1e-4 of max
    |logit| of the JAX package's, on 8-bit pools each model wrote itself."""
    rng = np.random.default_rng(seed)
    V = pair.cfg.vocab_size
    pages = [np.arange(1, 13), np.arange(13, 25)]
    a = rng.integers(1, V, 30)
    b = rng.integers(1, V, 11)
    steps = [
        (ForwardMode.EXTEND, [(a[:20], 0, pages[0]), (b, 0, pages[1])]),
        (ForwardMode.EXTEND, [(a[20:], 20, pages[0])]),
    ]
    for s in range(2):
        nxt = rng.integers(1, V, 2)
        steps.append((ForwardMode.DECODE, [(nxt[:1], 30 + s, pages[0]), (nxt[1:], 11 + s, pages[1])]))
    for mode, rows in steps:
        j, t = pair.step(mode, rows)
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max(), (mode, np.abs(t - j).max())


@pytest.mark.parametrize(
    "kv_dtype, quantization, seed",
    [
        ("int8", None, 1),
        ("fp8", None, 1),
        # W4A8 quantizes each projection's input rows to int8 on each side:
        # the prompts of seed 1 put one input of layer 1 3.8e-6 from a
        # rounding midpoint, the two sides round it apart, and that token's
        # layer-1 K/V codes and the logits (by 1.4e-2) follow. Seeds 2 to 4
        # give both pools identical codes.
        ("int8", "w4a8", 2),
    ],
)
def test_quant_kv_logits_match_jax(kv_dtype, quantization, seed):
    pair = Pair(VARIANTS["tiny-debug"], quantization=quantization, kv_dtype=kv_dtype)
    assert pair.kv.quantized and pair.kv.k.dtype == CODES[kv_dtype][0]
    _logits_rel_check(pair, seed)


@pytest.fixture(scope="module", params=[("int8", None), ("fp8", None), ("int8", "w4a8")],
                ids=["int8", "fp8", "w4a8-int8"])
def kv_engines(request):
    """Both engines at one setting: the JAX engine's weights (quantized by its
    runner for W4A8) loaded into the port's."""
    kv_dtype, quantization = request.param
    args = dict(ARGS, kv_cache_dtype=kv_dtype, quantization=quantization)
    jeng = JaxEngine(JaxServerArgs(**args))
    eng = Engine(ServerArgs(device="cpu", **args))
    runner = jeng.scheduler.runner
    params = jax.tree.map(np.asarray, runner.params)
    eng.scheduler.runner.model.load_state_dict(
        params_from_jax(
            params, eng.model_config,
            transposed=getattr(runner.model, "weights_transposed", False),
        )
    )
    return jeng, eng, kv_dtype


def test_quant_kv_greedy_tokens_match_jax(kv_engines):
    """The request set of ``test_torch_engine.py`` (a chunked prompt, a
    radix hit, decode windows) gives the same greedy tokens, up to the first
    step whose top-2 margin is a near tie."""
    jeng, eng, kv_dtype = kv_engines
    runner = eng.scheduler.runner
    assert runner.kv_cache_dtype == kv_dtype and runner.kv_cache.quantized
    assert jeng.scheduler.runner.args.kv_cache_dtype == kv_dtype
    _greedy_tokens_match(jeng, eng, stop_at_tie=True)
