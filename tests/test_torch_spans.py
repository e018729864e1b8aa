"""Bidirectional image spans (Gemma 3 multimodal) in the port's extend
attention against the JAX package's, on the CPU, in f32: the plain version
of ``csrc/paged_extend_attention.cu``'s span branch (rows 3m and 3qm)
against ``extend_attention_xla(mm_spans)`` (the JAX package extends Gemma 3
multimodal in XLA). The cases: a span that straddles query tiles, two
spans in one row, a span longer than the window (window 16 over 24-token
spans), a span after a cached prefix, a row without spans, a one-token row
and padding tokens (exact zeros), at head_dim 32 and 256, on f32 and int8
pages. Tolerance 2e-5 (8-bit pages 2e-4), as ``tests/test_torch_chunk.py``;
spans with a chunk are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.ops.attention.xla_backend import extend_attention_xla
from scratchpad_tpu_torch.ops.attention import attention_ragged, extend_attention_plain
from scratchpad_tpu_torch.ops.attention.ragged_backend import paged_extend_attention_plain
from test_torch_attention import LAYER, _extend_inputs, _pools
from test_torch_chunk import TOL, TOL_8BIT
from test_torch_chunk_extend import _extend_metas
from test_torch_kv_quant import _quant_pools
import torch_threads  # noqa: F401  (one torch thread a test process)

# (q_len, kv_len) a row, and its spans: absolute [s0, s1), (0, 0) for none
ROWS = [
    # a fresh prompt with two spans, the first across several query tiles
    ((70, 70), [(3, 27), (40, 64)]),
    # a chunk after a cached prefix that starts with a span
    ((30, 50), [(22, 46), (0, 0)]),
    # no spans; a one-token row
    ((12, 12), [(0, 0), (0, 0)]),
    ((1, 9), [(0, 0), (0, 0)]),
]


def _case(D: int, kv_dtype):
    chunks = [r[0] for r in ROWS]
    spans = np.asarray([r[1] for r in ROWS], np.int32)
    Hq, Hkv, ps = 4, 2, 4
    T_pad = sum(c[0] for c in chunks) + 5
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed=7 + D
    )
    if kv_dtype is None:
        jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    else:
        _, _, pt, jkv, tkv = _quant_pools(kv_lens.tolist(), Hkv, D, ps, kv_dtype, max(D, 128), seed=7 + D)
    jm, tm = _extend_metas(chunks, pt, kv_lens, q_lens, cu, q.shape[0])
    return q, jkv, tkv, jm, tm, spans, int(cu[-1])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("D, window", [(32, None), (32, 16), (256, 16)])
def test_extend_spans_match_jax(D, window, kv_dtype):
    q, jkv, tkv, jm, tm, spans, n_real = _case(D, kv_dtype)
    tol = TOL if kv_dtype is None else TOL_8BIT
    scale = 1.0 / np.sqrt(D)
    jm.mm_spans = jnp.asarray(spans)
    tm.mm_spans = torch.from_numpy(spans)
    ref = np.asarray(extend_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=4, sm_scale=scale,
                                          sliding_window=window))
    tq = torch.from_numpy(q)
    out = attention_ragged(tq, tkv, LAYER, tm, sm_scale=scale, sliding_window=window).numpy()
    plain = extend_attention_plain(tq, tkv, LAYER, tm, sm_scale=scale, sliding_window=window).numpy()
    np.testing.assert_allclose(out[:n_real], ref[:n_real], **tol)
    np.testing.assert_array_equal(out, plain)
    assert np.all(out[n_real:] == 0.0)
    # the spans move the rows that gain keys from them, and no other row
    tm.mm_spans = None
    causal = attention_ragged(tq, tkv, LAYER, tm, sm_scale=scale, sliding_window=window).numpy()
    moved = np.abs(causal - out).max(axis=(1, 2)) > 1e-6
    inside = np.zeros(q.shape[0], bool)
    t = 0
    for (q_len, kv_len), row_spans in ROWS:
        pos = np.arange(kv_len - q_len, kv_len)
        for s0, s1 in row_spans:
            # a span's last query gains nothing past itself, only the keys
            # before its window
            gains = (pos < s1 - 1) | (window is not None and pos - window + 1 > s0)
            inside[t : t + q_len] |= (pos >= s0) & (pos < s1) & gains
        t += q_len
    assert not (moved & ~inside).any()
    # a key's weight can round away on 8-bit pages: nearly all rows move
    assert moved[inside].mean() > 0.9


def test_spans_with_a_chunk_are_refused():
    q, _, tkv, _, tm, spans, _ = _case(32, None)
    k, v, _, _ = tkv.layer(LAYER)
    with pytest.raises(ValueError, match="chunk"):
        paged_extend_attention_plain(torch.from_numpy(q), k, v, tm.page_table, tm.seq_lens, tm.cu_q_lens,
                                     0.1, chunk_size=8, mm_spans=torch.from_numpy(spans))
    with pytest.raises(ValueError, match="int32"):
        paged_extend_attention_plain(torch.from_numpy(q), k, v, tm.page_table, tm.seq_lens, tm.cu_q_lens,
                                     0.1, mm_spans=torch.from_numpy(spans).long())
