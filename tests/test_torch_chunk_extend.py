"""Chunked attention (Llama-4's rope layers) in the port's extend attention
against the JAX package's, on the CPU, in f32: the plain version of
``csrc/paged_extend_attention.cu``'s chunk branch against
``extend_attention_xla(chunk_size=...)`` (the JAX package extends Llama-4 in
XLA), chunks of 4, 8 and 16: a fresh prompt that crosses several chunk
edges, a chunk after a cached prefix whose first query sits a token before
an edge, a one-token row, padding tokens (exact zeros); bf16-layout and
int8 pages. Tolerance 2e-5 (8-bit pages 2e-4), as ``tests/test_torch_chunk.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.ops.attention.xla_backend import extend_attention_xla
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.ops.attention import attention_ragged, extend_attention_plain
from test_torch_attention import LAYER, _extend_inputs, _pools
from test_torch_chunk import TOL, TOL_8BIT
from test_torch_kv_quant import _quant_pools
import torch_threads  # noqa: F401  (one torch thread a test process)


def _extend_metas(chunks, pt, kv_lens, q_lens, cu, T):
    B = len(chunks)
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
    return jm, tm


def extend_chunks(C: int) -> list:
    """(q_len, kv_len): a fresh prompt across several chunk edges, a chunk
    after a cached prefix whose first query sits a token before an edge,
    and a one-token row."""
    return [(3 * C + 5, 3 * C + 5), (C + 3, 3 * C + 2), (1, 2 * C + 1)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("C", [4, 8, 16])
def test_extend_chunk_matches_jax(C, kv_dtype):
    chunks = extend_chunks(C)
    Hq, Hkv, D, ps = 10, 2, 32, 4
    T_pad = sum(c[0] for c in chunks) + 5
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed=40 + C
    )
    if kv_dtype is None:
        jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
        tol = TOL
    else:
        _, _, pt, jkv, tkv = _quant_pools(kv_lens.tolist(), Hkv, D, ps, kv_dtype, 128, seed=40 + C)
        tol = TOL_8BIT
    T, n_real = q.shape[0], int(cu[-1])
    jm, tm = _extend_metas(chunks, pt, kv_lens, q_lens, cu, T)
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(extend_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sm_scale=scale,
                                          chunk_size=C))
    out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale, chunk_size=C).numpy()
    plain = extend_attention_plain(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale,
                                   chunk_size=C).numpy()
    np.testing.assert_allclose(out[:n_real], ref[:n_real], **tol)
    np.testing.assert_array_equal(out, plain)
    assert np.all(out[n_real:] == 0.0)
    whole = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale).numpy()
    assert np.abs(whole - out).max() > 1e-2
