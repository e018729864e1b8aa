"""Chunked attention (Llama-4's rope layers) in the port's decode and extend
attention against the JAX package's, on the CPU, in f32.

- Decode: the plain version of ``csrc/paged_decode_attention.cu``'s chunk
  branch, through ``decode_attention_gqa``, against the JAX
  ``decode_attention_gqa`` in interpret mode (``_gqa_decode_call`` with
  ``chunk_size``: ``mask_start`` and ``first_chunk``, as
  ``tests/test_pallas_kernels.py`` runs the kernel) and
  ``decode_attention_xla(chunk_size=...)``: chunks of 4, 7 and 16 tokens,
  rows ending a token before, on and after a chunk edge and past two chunks,
  a row long enough that the JAX kernel skips a whole 16-page chunk, rows
  of length 0 (exact zeros); bf16-layout, int8 and fp8 pages; G 5
  (Llama-4 Scout's grouping, over 2 kv heads). Tolerance 2e-5, the JAX
  kernel tests' own; 8-bit pages 2e-4.
- Extend: ``tests/test_torch_chunk_extend.py`` (its own file, for the
  six-worker run's time).
- ``mask_args``: the chunk as the kernels take it (0 for none), a window
  and a chunk together refused.

The kernels themselves against these plain versions are in
``tests/test_torch_gpu.py`` (``-k chunk``), which imports no JAX and so runs
on the card's machine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.xla_backend import decode_attention_xla
from scratchpad_tpu_torch.ops.attention import decode_attention_gqa
from scratchpad_tpu_torch.ops.attention.gqa_decode import mask_args
from test_torch_attention import LAYER, _case, _decode_metas, _pools
from test_torch_kv_quant import _quant_pools
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_8BIT = dict(rtol=2e-4, atol=2e-4)
CHUNKS = [4, 7, 16]


def edge_lens(C: int) -> np.ndarray:
    """A token before, on and after a chunk edge, past two chunks, a row
    whose chunk starts past the JAX kernel's first 16-page chunk (300
    tokens at page 16), and rows of length 0."""
    return np.asarray([C - 1, C, C + 1, 2 * C + 17, 0, 300, 0], np.int32)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("C", CHUNKS)
def test_decode_chunk_matches_jax(C, kv_dtype):
    seq_lens = edge_lens(C)
    Hq, Hkv, D, ps = 10, 2, 64, 16
    if kv_dtype is None:
        rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=C)
        jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, 128)
        tol = TOL
    else:
        rng, _, pt, jkv, tkv = _quant_pools(seq_lens.tolist(), Hkv, D, ps, kv_dtype, 128, seed=C)
        tol = TOL_8BIT
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    jm, tm = _decode_metas(pt, seq_lens)
    ref_gqa = np.asarray(jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sm_scale=0.125,
                                 chunk_size=C))
    ref_xla = np.asarray(decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps,
                                              sm_scale=0.125, chunk_size=C))
    out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=0.125, chunk_size=C).numpy()
    np.testing.assert_allclose(out, ref_gqa, **tol)
    np.testing.assert_allclose(out, ref_xla, **tol)
    assert np.all(out[seq_lens == 0] == 0.0)
    # the chunk masks something on every row that crosses an edge
    whole = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=0.125).numpy()
    crossed = seq_lens > C
    assert np.abs(whole - out)[crossed].reshape(int(crossed.sum()), -1).max(axis=1).min() > 1e-3
    np.testing.assert_array_equal(whole[seq_lens <= C], out[seq_lens <= C])


def test_mask_args_take_the_chunk():
    assert mask_args(None, None, 8192) == (0.0, 0, 8192)
    assert mask_args(None, 1 << 30, 16) == (0.0, 0, 16)  # the global sentinel is no window
    assert mask_args(30.0, None) == (30.0, 0, 0)
    for bad in (0, -4):
        with pytest.raises(ValueError, match="chunk_size"):
            mask_args(None, None, bad)
    with pytest.raises(ValueError, match="window"):
        mask_args(None, 128, 8192)
