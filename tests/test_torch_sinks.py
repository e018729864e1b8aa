"""Attention sinks (GPT-OSS) in the port's decode and extend attention against
the JAX package's, on the CPU, in f32.

- Decode: the plain version of ``csrc/paged_decode_attention.cu``'s sinks
  branch, through ``decode_attention_gqa``, against the JAX
  ``decode_attention_gqa`` in interpret mode (its ``with_sinks`` branch, as
  ``tests/test_pallas_kernels.py`` runs it) and ``decode_attention_xla``:
  sinks of N(0, 2^2), +8 and -8, with and without a per-call window, over
  bf16-layout, int8 and fp8 pages, with ``seq_len == 0`` rows, which stay
  exact zeros (also under a sink of +100). Tolerance 2e-5, the JAX kernel
  tests' own; 8-bit pages 2e-4.
- Extend: the plain version of ``csrc/paged_extend_attention.cu``'s sinks
  branch against ``extend_attention_xla``, the window's edge inside a chunk,
  padding tokens exact zeros. Tolerance 2e-5.
- The wrappers' sinks argument: what the kernels take (contiguous f32
  ``[Hq]``) and nothing else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.xla_backend import decode_attention_xla, extend_attention_xla
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.ops.attention import (
    attention_ragged,
    decode_attention_gqa,
    decode_attention_plain,
    extend_attention_plain,
)
from scratchpad_tpu_torch.ops.attention.gqa_decode import sinks_arg
from test_torch_attention import LAYER, _case, _decode_metas, _extend_inputs, _pools
from test_torch_kv_quant import _quant_pools

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_8BIT = dict(rtol=2e-4, atol=2e-4)
SINKS = ["normal", "plus8", "minus8"]


def _sinks(kind: str, Hq: int, seed: int) -> np.ndarray:
    """f32 [Hq]: N(0, 2^2), or every head at +8 (above most scores) or -8."""
    if kind == "normal":
        return (2.0 * np.random.default_rng(seed).normal(size=Hq)).astype(np.float32)
    return np.full(Hq, 8.0 if kind == "plus8" else -8.0, np.float32)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("kind", SINKS)
def test_decode_sinks_match_jax(kind, window, kv_dtype):
    """GPT-OSS's grouping (G 8 at head_dim 64, here over 2 kv heads), rows
    across pages and a 16-page chunk, rows of length 0."""
    seq_lens = np.asarray([300, 0, 17, 260, 0], np.int32)
    Hq, Hkv, D, ps = 16, 2, 64, 16
    if kv_dtype is None:
        rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=21)
        jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, 128)
        tol = TOL
    else:
        rng, _, pt, jkv, tkv = _quant_pools(seq_lens.tolist(), Hkv, D, ps, kv_dtype, 128, seed=21)
        tol = TOL_8BIT
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    sinks = _sinks(kind, Hq, seed=22)
    jm, tm = _decode_metas(pt, seq_lens)
    kw = dict(sm_scale=0.125, sliding_window=window)
    jwin = dict(kw, sliding_window=None if window is None else jnp.int32(window))
    ref_gqa = np.asarray(jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=ps,
                                 sinks=jnp.asarray(sinks), **jwin))
    ref_xla = np.asarray(decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps,
                                              sinks=jnp.asarray(sinks), **kw))
    out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sinks=torch.from_numpy(sinks),
                               **kw).numpy()
    np.testing.assert_allclose(out, ref_gqa, **tol)
    np.testing.assert_allclose(out, ref_xla, **tol)
    assert np.all(out[seq_lens == 0] == 0.0)
    if kv_dtype is None:  # sinks that reach the scores move the rows
        bare = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
        move = np.abs(bare - out).max() / np.abs(bare).max()
        assert move > 1e-2 if kind != "minus8" else move < 1e-2


def test_decode_empty_rows_stay_zero_under_a_large_sink():
    """A row of length 0 holds only the sink: its output is exact zeros, free
    of NaN, even for a sink of +100 (and live rows go to about zero)."""
    seq_lens = np.asarray([0, 40, 0], np.int32)
    Hq, Hkv, D, ps = 8, 1, 64, 16
    rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=4)
    _, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    q = torch.from_numpy(rng.normal(size=(3, Hq, D)).astype(np.float32))
    _, tm = _decode_metas(pt, seq_lens)
    out = decode_attention_plain(q, tkv, LAYER, tm, sm_scale=0.125,
                                 sinks=torch.full((Hq,), 100.0)).numpy()
    assert np.isfinite(out).all()
    assert np.all(out[[0, 2]] == 0.0)
    assert np.abs(out[1]).max() < 1e-30


EXTEND_CASES = [
    # page 4, window 8: a fresh prompt, a chunk after a cached prefix, a
    # one-token row, padding tokens
    ([(9, 9), (6, 30), (1, 13)], 16, 2, 32, 4, 20, 8),
    # page 16, G 8 at head_dim 64 (GPT-OSS's grouping), no window
    ([(16, 48), (20, 20)], 16, 2, 64, 16, 40, None),
]


@pytest.mark.parametrize("kind", SINKS)
@pytest.mark.parametrize("chunks, Hq, Hkv, D, ps, T_pad, window", EXTEND_CASES)
def test_extend_sinks_match_jax(chunks, Hq, Hkv, D, ps, T_pad, window, kind):
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed=3 + D
    )
    T, n_real, B = q.shape[0], int(cu[-1]), len(chunks)
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
    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    sinks = _sinks(kind, Hq, seed=5)
    ref = np.asarray(extend_attention_xla(
        jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sm_scale=scale, sliding_window=window,
        sinks=jnp.asarray(sinks),
    ))
    kw = dict(sm_scale=scale, sliding_window=window, sinks=torch.from_numpy(sinks))
    out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
    plain = extend_attention_plain(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
    np.testing.assert_allclose(out[:n_real], ref[:n_real], **TOL)
    np.testing.assert_array_equal(out, plain)
    assert np.all(out[n_real:] == 0.0)
    bare = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale,
                            sliding_window=window).numpy()
    move = np.abs(bare - out).max() / np.abs(bare).max()
    assert move > 1e-2 if kind != "minus8" else move < 1e-2


def test_sinks_argument_is_what_the_kernels_take():
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    assert sinks_arg(None, q) == 0
    good = torch.zeros(8)
    assert sinks_arg(good, q) == good.data_ptr()
    for bad in (torch.zeros(8, dtype=torch.bfloat16), torch.zeros(4), torch.zeros(16)[::2],
                torch.zeros(1, 8)):
        with pytest.raises(ValueError, match="sinks"):
            sinks_arg(bad, q)


@pytest.mark.parametrize("window", [None, 5])
def test_sdpa_yardstick_is_the_softmax_with_sinks(window):
    """``chip_smoke.py`` times the sinks rows' library call as one SDPA over
    K/V with a zero key and value appended, each head's sink that key's
    additive mask (``sink_mask``): in f32 it is the attention with sinks of
    the plain versions (``softmax_with_sinks``), within 1e-5."""
    import torch.nn.functional as F

    from chip_smoke import sink_mask, with_zero_key
    from scratchpad_tpu_torch.ops.attention.gqa_decode import softmax_with_sinks

    gen = torch.Generator().manual_seed(5)
    B, Hkv, G, Lq, S, D = 2, 2, 4, 3, 11, 16
    q = torch.randn(B, Hkv * G, Lq, D, generator=gen)
    k, v = (torch.randn(B, Hkv, S, D, generator=gen) for _ in range(2))
    sinks = 2.0 * torch.randn(Hkv * G, generator=gen)
    j, p = torch.arange(S)[None, :], (S - Lq + torch.arange(Lq))[:, None]
    keep = (j <= p) & (j > p - (window or S + 1))
    scale = D**-0.5
    got = F.scaled_dot_product_attention(
        q, with_zero_key(k), with_zero_key(v), attn_mask=sink_mask(keep, sinks, torch.float32),
        scale=scale, enable_gqa=True,
    )
    kg, vg = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    scores = (q @ kg.transpose(-1, -2) * scale).masked_fill(~keep, float("-inf"))
    want = softmax_with_sinks(scores, sinks, (1, Hkv * G, 1, 1)) @ vg
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
