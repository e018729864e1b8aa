"""The port's attention (plain PyTorch paths of the CUDA kernels) against the
JAX package's, on the CPU, in f32.

Both sides write the same K/V through their own ``write_kv`` into their own
pool layouts (the JAX pool interleaves K/V heads and lane-pads head_dim for
its Pallas kernels; the port's does neither), so the comparison is on
attention outputs, never on pool bytes. The JAX decode kernel runs in
interpret mode, as ``tests/test_pallas_kernels.py`` runs it. Tolerance
2e-5: both sides compute in f32; sums run in different orders.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.ragged_backend import _ragged_dense_ref
from scratchpad_tpu.ops.attention.xla_backend import (
    decode_attention_xla,
    extend_attention_xla,
)
from scratchpad_tpu.ops.attention.xla_backend import write_kv as jax_write_kv
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.ops.attention import (
    decode_attention_gqa,
    attention_ragged,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_extend_attention,
    paged_extend_attention_plain,
    write_kv,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=2e-5, atol=2e-5)
LAYERS, LAYER = 2, 1


def _case(kv_lens, Hkv, D, ps, seed):
    """Random K/V for every cached token of every sequence, shuffled pages
    (page 0 is the dump page), and each token's layer-local slot."""
    rng = np.random.default_rng(seed)
    need = [max(-(-n // ps), 1) for n in kv_lens]
    num_pages = sum(need) + 1
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((len(kv_lens), max(need)), np.int32)
    o = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[o : o + n]
        o += n
    loc = np.concatenate(
        [pt[b, np.arange(n) // ps] * ps + np.arange(n) % ps for b, n in enumerate(kv_lens)]
    ).astype(np.int32)
    k = rng.normal(size=(len(loc), Hkv, D)).astype(np.float32)
    v = rng.normal(size=(len(loc), Hkv, D)).astype(np.float32)
    return rng, num_pages, pt, loc, k, v


def _pools(num_pages, ps, Hkv, D, loc, k, v, jax_head_dim):
    """The same K/V written into a JAX pool (``jax_head_dim`` lanes) and a
    port pool, each through its own ``write_kv``, at layer LAYER."""
    jcfg = JaxKVConfig(
        num_layers=LAYERS, num_pages=num_pages, page_size=ps,
        num_kv_heads=Hkv, head_dim=jax_head_dim, dtype=jnp.float32,
    )
    jkv = jax_write_kv(
        jax_create_kv_cache(jcfg), jnp.asarray(k), jnp.asarray(v), LAYER, jnp.asarray(loc)
    )
    tcfg = KVCacheConfig(LAYERS, num_pages, ps, Hkv, D, torch.float32)
    tkv = create_kv_cache(tcfg, torch.device("cpu"))
    write_kv(tkv, torch.from_numpy(k), torch.from_numpy(v), LAYER, torch.from_numpy(loc).long())
    return jkv, tkv


def _decode_metas(pt, seq_lens):
    B = len(seq_lens)
    jm = JaxMeta(
        mode=JaxMode.DECODE,
        tokens=jnp.zeros(B, jnp.int32),
        positions=jnp.asarray(np.maximum(seq_lens - 1, 0)),
        out_cache_loc=jnp.zeros(B, jnp.int32),
        req_indices=jnp.arange(B, dtype=jnp.int32),
        page_table=jnp.asarray(pt),
        seq_lens=jnp.asarray(seq_lens),
        extend_lens=jnp.ones(B, jnp.int32),
        last_token_idx=jnp.arange(B, dtype=jnp.int32),
    )
    rows = torch.arange(B)
    tm = ForwardMeta(
        mode=ForwardMode.DECODE,
        tokens=torch.zeros(B, dtype=torch.long),
        positions=torch.from_numpy(np.maximum(seq_lens - 1, 0)).long(),
        out_cache_loc=torch.zeros(B, dtype=torch.long),
        req_indices=rows,
        page_table=torch.from_numpy(pt),
        seq_lens=torch.from_numpy(seq_lens),
        extend_lens=torch.ones(B, dtype=torch.int32),
        last_token_idx=rows,
    )
    return jm, tm


@pytest.mark.parametrize(
    "seq_lens, Hq, Hkv, D, ps",
    [
        # B >= 2 and every page table inside one 16-page chunk: the JAX
        # package picks its grouped kernel here
        ([37, 120, 256, 5], 8, 2, 32, 16),
        # one sequence over several 16-page chunks: the per-sequence kernel
        ([700], 8, 2, 32, 16),
        # several sequences, multi-chunk, head_dim 64, GQA group 4
        ([300, 17, 520], 16, 4, 64, 16),
        # padding rows (seq_len 0) beside real ones; page size 4
        ([45, 0, 12, 0], 4, 2, 32, 4),
    ],
)
def test_decode_matches_jax(seq_lens, Hq, Hkv, D, ps):
    seq_lens = np.asarray(seq_lens, np.int32)
    rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=int(seq_lens.sum()))
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    jm, tm = _decode_metas(pt, seq_lens)

    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    ref_xla = np.array(
        decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sm_scale=scale)
    )
    jkv_pad, _ = _pools(num_pages, ps, Hkv, D, loc, k, v, 128)
    ref_gqa = np.asarray(
        jax_gqa(jnp.asarray(q), jkv_pad, LAYER, jm, page_size=ps, sm_scale=scale)
    )
    out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale).numpy()

    pad = seq_lens == 0
    ref_xla[pad] = 0.0  # the XLA reference leaves padding rows undefined
    np.testing.assert_allclose(out, ref_xla, **TOL)
    np.testing.assert_allclose(out, ref_gqa, **TOL)
    assert np.all(out[pad] == 0.0)


def _extend_inputs(chunks, Hq, Hkv, D, ps, T_pad, seed):
    """chunks: (q_len, kv_len) per sequence; the queries of a sequence are
    its last q_len cached tokens; tokens past the chunks are padding."""
    kv_lens = [c[1] for c in chunks]
    rng, num_pages, pt, loc, k, v = _case(kv_lens, Hkv, D, ps, seed)
    q_lens = np.asarray([c[0] for c in chunks], np.int32)
    T = max(T_pad, int(q_lens.sum()))
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return num_pages, pt, loc, k, v, q, np.asarray(kv_lens, np.int32), q_lens, cu


EXTEND_CASES = [
    # fresh prompt, a chunk after a cached prefix, a one-token row, padding
    ([(9, 9), (6, 30), (1, 13)], 8, 2, 32, 4, 20),
    # head_dim 64, GQA group 4, chunks of a chunked prefill
    ([(16, 48), (20, 20)], 16, 4, 64, 16, 36),
]


@pytest.mark.parametrize("chunks, Hq, Hkv, D, ps, T_pad", EXTEND_CASES)
def test_extend_matches_jax(chunks, Hq, Hkv, D, ps, T_pad):
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed=len(chunks) + D
    )
    T, n_real, B = q.shape[0], int(cu[-1]), len(chunks)
    scale = 1.0 / np.sqrt(D)
    req = np.full(T, B - 1, np.int32)
    pos = np.zeros(T, np.int32)
    for s, (ql, kl) in enumerate(chunks):
        req[cu[s] : cu[s + 1]] = s
        pos[cu[s] : cu[s + 1]] = np.arange(kl - ql, kl)
    jm = JaxMeta(
        mode=JaxMode.EXTEND,
        tokens=jnp.zeros(T, jnp.int32),
        positions=jnp.asarray(pos),
        out_cache_loc=jnp.zeros(T, jnp.int32),
        req_indices=jnp.asarray(req),
        page_table=jnp.asarray(pt),
        seq_lens=jnp.asarray(kv_lens),
        extend_lens=jnp.asarray(q_lens),
        last_token_idx=jnp.asarray(cu[1:] - 1),
    )
    tm = ForwardMeta(
        mode=ForwardMode.EXTEND,
        tokens=torch.zeros(T, dtype=torch.long),
        positions=torch.from_numpy(pos).long(),
        out_cache_loc=torch.zeros(T, dtype=torch.long),
        req_indices=torch.from_numpy(req).long(),
        page_table=torch.from_numpy(pt),
        seq_lens=torch.from_numpy(kv_lens),
        extend_lens=torch.from_numpy(q_lens),
        last_token_idx=torch.from_numpy(cu[1:] - 1).long(),
        cu_q_lens=torch.from_numpy(cu),
    )
    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    ref_xla = np.asarray(
        extend_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sm_scale=scale)
    )
    # the dense reference of the bundled ragged kernel: pages of layer
    # LAYER sit at global page LAYER * pages_per_layer + p; q is pre-scaled
    ref_dense = np.asarray(
        _ragged_dense_ref(
            jnp.asarray(q) * scale, jkv.kv, jnp.asarray(kv_lens),
            jnp.asarray(pt + LAYER * num_pages), jnp.asarray(cu),
            jnp.asarray([B], jnp.int32), sm_scale=1.0, logit_cap=None,
            sliding_window=None,
        )
    )
    out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale).numpy()
    np.testing.assert_allclose(out[:n_real], ref_xla[:n_real], **TOL)
    np.testing.assert_allclose(out[:n_real], ref_dense[:n_real], **TOL)
    assert np.all(out[n_real:] == 0.0)  # padding tokens come out as zeros


def test_write_kv_round_trip():
    """Rows written at scattered slots read back unchanged through the
    layer view, other layers and slots untouched."""
    Hkv, D, ps = 2, 8, 4
    _, num_pages, pt, loc, k, v = _case([7, 10], Hkv, D, ps, seed=3)
    tkv = create_kv_cache(KVCacheConfig(LAYERS, num_pages, ps, Hkv, D, torch.float32), torch.device("cpu"))
    write_kv(tkv, torch.from_numpy(k), torch.from_numpy(v), LAYER, torch.from_numpy(loc).long())
    kl, vl, _, _ = tkv.layer(LAYER)
    rows = torch.from_numpy(loc).long()
    assert torch.equal(kl.reshape(-1, Hkv, D)[rows], torch.from_numpy(k))
    assert torch.equal(vl.reshape(-1, Hkv, D)[rows], torch.from_numpy(v))
    untouched = torch.ones(num_pages * ps, dtype=torch.bool)
    untouched[rows] = False
    assert not kl.reshape(-1, Hkv, D)[untouched].any()
    assert not tkv.k[1 - LAYER].any() and not tkv.v[1 - LAYER].any()


def test_cpu_wrappers_take_plain_versions():
    """On CPU tensors the kernel wrappers return their plain versions'
    results and launch nothing."""
    Hkv, D, ps = 2, 32, 4
    _, num_pages, pt, loc, k, v = _case([9, 3], Hkv, D, ps, seed=5)
    _, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    kl, vl, _, _ = tkv.layer(LAYER)
    q = torch.randn(2, 4, D, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([9, 3], dtype=torch.int32)
    pt_t = torch.from_numpy(pt)
    before = (paged_decode_attention.launches, paged_extend_attention.launches)
    assert torch.equal(
        paged_decode_attention(q, kl, vl, pt_t, lens, 0.5),
        paged_decode_attention_plain(q, kl, vl, pt_t, lens, 0.5),
    )
    cu = torch.tensor([0, 1, 2], dtype=torch.int32)
    assert torch.equal(
        paged_extend_attention(q, kl, vl, pt_t, lens, cu, 0.5),
        paged_extend_attention_plain(q, kl, vl, pt_t, lens, cu, 0.5),
    )
    assert (paged_decode_attention.launches, paged_extend_attention.launches) == before
