"""The decode ablation probe of the port against the JAX package's.

``tools/profiling/_ablate.py`` runs its timing loop when imported, so its
``make_kernel`` and ``_NEG`` are read from the file's text and executed
here beside ``pl``/``pltpu``; the kernel runs in interpret mode on the CPU.
The port's ``decode_ablate`` (its plain version, on CPU tensors) must give
the JAX kernel's ``out`` within one bf16 ulp for every mode, and its ``aux``
must match the numpy reference below (f64 sums, p rounded to bf16 as the
kernels round it; rtol 1e-5, atol 1e-4: f32 against f64 sums of at most a
few hundred terms). ``full``'s checksum over ``l`` is the decode itself:
it must equal ``sum_d |.|`` of ``paged_decode_attention_plain`` (sm_scale 1)
on the K and V split out of the pool, within the bf16 rounding of p that
only the probe does: ``2**-8 sum_d`` of the same decode over ``|V|``, 2x
the bound of that rounding.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scratchpad_tpu_torch.ops.attention import decode_ablate, paged_decode_attention_plain
from scratchpad_tpu_torch.ops.attention.decode_ablate import MODES, NEG
from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention_stage_plain
import torch_threads  # noqa: F401  (one torch thread a test process)

ABLATE = Path(__file__).resolve().parent.parent / "tools" / "profiling" / "_ablate.py"

# (B, page, chunk pages, Hkv, Hq, Dp, seq_lens, table width): lengths 0 and 1,
# a page edge (4, 8), two chunks (16 at a chunk of 8 rows; 9 and 17 past an
# edge), G 2, 3 and 4, a table wider than the rows need
SHAPES = [
    (4, 4, 2, 2, 4, 8, [0, 1, 4, 16], 4),
    (3, 4, 2, 2, 6, 16, [9, 1, 0], 6),
    (2, 8, 1, 1, 4, 32, [8, 17], 3),
]


def _jax_make_kernel():
    tree = ast.parse(ABLATE.read_text())
    keep = [
        n for n in tree.body
        if (isinstance(n, ast.FunctionDef) and n.name == "make_kernel")
        or (isinstance(n, ast.Assign) and any(getattr(t, "id", None) == "_NEG" for t in n.targets))
    ]
    assert len(keep) == 2, "make_kernel or _NEG moved in _ablate.py"
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(ABLATE), "exec"), ns)
    assert ns["_NEG"] == NEG
    return ns["make_kernel"]


MAKE_KERNEL = _jax_make_kernel()


def _jax_ablate(mode, q, kv, pt, lens, ps, CP):
    """``_ablate.py::run``'s pallas_call (``:97-106``) on the given inputs."""
    B, Hq, Dp = q.shape
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(B,),
        in_specs=[pl.BlockSpec((1, Hq, Dp), lambda b, *_: (b, 0, 0)),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, Hq, Dp), lambda b, *_: (b, 0, 0)),
        scratch_shapes=[pltpu.VMEM((2, CP, ps, kv.shape[2], Dp), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2,)), pltpu.SMEM((1,), jnp.int32)],
    )
    f = pl.pallas_call(MAKE_KERNEL(mode, ps, CP), grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((B, Hq, Dp), jnp.bfloat16), interpret=True)
    out = f(jnp.asarray(pt), jnp.asarray(lens), jnp.asarray(q, jnp.bfloat16),
            jnp.asarray(kv, jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32))


def _bf16(a):
    """Round f32 values to bf16 (nearest, ties to even) and back, in numpy."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _ulp(x):
    """One bf16 ulp of each value (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _inputs(shape, seed):
    B, ps, CP, Hkv, Hq, Dp, lens, P = shape
    rng = np.random.default_rng(seed)
    pages = 24
    kv = _bf16(rng.standard_normal((pages, ps, 2 * Hkv, Dp)))
    q = _bf16(rng.standard_normal((B, Hq, Dp)))
    pt = rng.integers(0, pages, (B, P)).astype(np.int32)
    return q, kv, pt, np.asarray(lens, np.int32)


def _port(mode, q, kv, pt, lens, CP):
    out, aux = decode_ablate(torch.tensor(q).to(torch.bfloat16), torch.tensor(kv).to(torch.bfloat16),
                             torch.tensor(pt), torch.tensor(lens), mode, CP)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    return out.float().numpy(), aux.numpy()


def _np_aux(mode, q, kv, pt, lens, CP):
    """(m, l, checksum) per (b, h), written from ``_ablate.py``'s loop
    (``:58-79``) and the checksums of ``decode_ablate_plain``'s docstring."""
    B, Hq, Dp = q.shape
    ps, Hkv = kv.shape[1], kv.shape[2] // 2
    G, CH = Hq // Hkv, CP * ps
    aux = np.zeros((B, Hq, 3))
    for b in range(B):
        n = max(-(-int(lens[b]) // CH), 1)
        for h in range(Hq):
            k = h // G
            m, l, cs = float(np.float32(NEG)), 0.0, 0.0
            acc = np.zeros(Dp)
            for c in range(n):
                rows = kv[pt[b, c * CP : (c + 1) * CP]].reshape(CH, 2 * Hkv, Dp).astype(np.float64)
                K, V = rows[:, 2 * k], rows[:, 2 * k + 1]
                col = c * CH + np.arange(CH)
                if mode == "dma_only":
                    cs += K[0, 0]
                    continue
                if mode == "reshape_only":
                    cs += np.abs(K).sum() + np.abs(V).sum()
                    continue
                s = K @ q[b, h].astype(np.float64)
                if mode == "sdot_only":
                    l += s.sum()
                    cs += np.abs(s).sum()
                    continue
                s = np.where(col < lens[b], s, NEG)
                m_new = max(m, s.max())
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new)
                l = l * alpha + p.sum()
                acc = acc * alpha + _bf16(p) @ V
                m = m_new
            if mode == "full":
                cs = np.abs(acc).sum()
            aux[b, h] = m, l, cs
    return aux


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["G2", "G3", "G4-CP1"])
def test_plain_matches_jax_make_kernel(shape, mode):
    CP, ps = shape[2], shape[1]
    q, kv, pt, lens = _inputs(shape, seed=SHAPES.index(shape))
    want = _jax_ablate(mode, q, kv, pt, lens, ps, CP)
    out, aux = _port(mode, q, kv, pt, lens, CP)
    assert np.all(np.abs(out - want) <= _ulp(want)), np.abs(out - want).max()
    np.testing.assert_allclose(aux, _np_aux(mode, q, kv, pt, lens, CP), rtol=1e-5, atol=1e-4)
    if mode in ("dma_only", "reshape_only", "sdot_only"):
        # the JAX statistic hides these stages' work: every row reads -1e30
        assert np.all(want == np.float32(_bf16(np.float32(NEG))))


@pytest.mark.parametrize("mode", ["no_pv", "full"])
def test_two_layer_chain_matches_jax(mode):
    """Each layer's out is the next layer's q (``_ablate.py:108-113``)."""
    shape = SHAPES[1]
    CP, ps = shape[2], shape[1]
    q, kv, pt, lens = _inputs(shape, seed=7)
    want = _jax_ablate(mode, _jax_ablate(mode, q, kv, pt, lens, ps, CP), kv, pt, lens, ps, CP)
    out, _ = _port(mode, q, kv, pt, lens, CP)
    out, _ = _port(mode, out, kv, pt, lens, CP)
    assert np.all(np.abs(out - want) <= _ulp(want)), np.abs(out - want).max()


@pytest.mark.parametrize("shape", SHAPES, ids=["G2", "G3", "G4-CP1"])
def test_full_checksum_is_the_decode(shape):
    CP = shape[2]
    q, kv, pt, lens = _inputs(shape, seed=11)
    _, aux = _port("full", q, kv, pt, lens, CP)
    t = lambda a: torch.tensor(np.ascontiguousarray(a)).to(torch.bfloat16)
    K, V = t(kv[:, :, 0::2]), t(kv[:, :, 1::2])
    qf, ptt, lt = t(q).float(), torch.tensor(pt), torch.tensor(lens)
    dec = paged_decode_attention_plain(qf, K, V, ptt, lt, 1.0).abs().sum(-1).numpy()
    mag = paged_decode_attention_plain(qf, K, V.abs(), ptt, lt, 1.0).sum(-1).numpy()
    rows = lens >= 1
    got = aux[..., 2] / aux[..., 1]
    assert np.all(np.abs(got - dec)[rows] <= 2.0**-8 * mag[rows] + 1e-5)


def test_wrapper_refuses_narrow_table():
    q, kv, pt, lens = _inputs(SHAPES[0], seed=0)  # 16 tokens: 2 chunks of 2 pages
    with pytest.raises(ValueError, match="entries a row"):
        _port("full", q, kv, pt[:, :3], lens, 2)
    with pytest.raises(ValueError, match="mode"):
        _port("pv_only", q, kv, pt, lens, 2)


def _np_stage(stage, q, k, v, pt, lens, scale):
    B, Hq, D = q.shape
    Hkv, ps = k.shape[2], k.shape[1]
    G = Hq // Hkv
    out = np.zeros((B, Hq, D))
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        slots = (pt[b][:, None] * ps + np.arange(ps)).reshape(-1)[:n]
        K = k.reshape(-1, Hkv, D)[slots].astype(np.float64)
        V = v.reshape(-1, Hkv, D)[slots].astype(np.float64)
        for h in range(Hq):
            s = K[:, h // G] @ q[b, h].astype(np.float64) * scale
            vs = np.abs(V[:, h // G]).sum(0)
            p = np.exp(s - s.max())
            out[b, h] = {
                1: vs + np.abs(K[:, h // G]).sum(0),
                2: np.abs(s).sum() + vs,
                3: abs(s.max()) + vs / p.sum(),
                4: p @ V[:, h // G] / p.sum(),
                5: p @ V[:, h // G] / p.sum() + vs / n,
            }[stage]
    return out


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_stage_plain_matches_numpy(stage):
    rng = np.random.default_rng(stage)
    B, Hkv, G, D, ps = 3, 2, 3, 16, 4
    lens = np.array([0, 1, 13], np.int32)
    k = _bf16(rng.standard_normal((12, ps, Hkv, D)))
    v = _bf16(rng.standard_normal((12, ps, Hkv, D)))
    q = _bf16(rng.standard_normal((B, Hkv * G, D)))
    pt = rng.permutation(12)[: B * 4].reshape(B, 4).astype(np.int32)
    t = lambda a: torch.tensor(a).to(torch.bfloat16)
    got = paged_decode_attention_stage_plain(stage, t(q), t(k), t(v), torch.tensor(pt),
                                             torch.tensor(lens), 0.25)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _np_stage(stage, q, k, v, pt, lens, 0.25),
                               rtol=1e-5, atol=1e-5)
