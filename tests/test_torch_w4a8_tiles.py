"""The W4A8 GEMM's launch plan and arithmetic, on the CPU.

- A plain emulation of the arithmetic of ``csrc/w4a8_matmul.cu`` against the
  JAX package's functions on the same numpy-seeded inputs, at the card's gate
  |emu - ref| <= 1e-4 + 2**-8 |ref|: the zero point folded into the code
  (nibble - zc, an s8 with zc the zero clamped to [0, 16]), exact i32 dots a
  32-deep k step, folded into f32 as ``tot = fma(f32(D) [+ gsum * r], s,
  tot)`` after every step that ends a group and at each split's end, and
  after every 128-deep span where g % 128 == 0 or g > 2,048 (a narrower
  group's i32 sum stays below 2**22; r = zc - z, taken at a group's end),
  the splits' partials
  added in the plan's order, times ax, one bf16 rounding. A step that holds
  a group edge (a group of 32 or more that is no multiple of 32: GPT-OSS's
  120 and 100, and 33) is issued twice, the codes before the edge with the
  first group's zero, then those from it with the next group's, the first
  group folded (with its rest) between the two. Held against
  ``_w4a8_kernel_q4`` (interpret mode, on the same int8 rows: the JAX
  package's ``_w4_q4_call`` quantizes x under ``jit``, where x / ax becomes
  a product with a reciprocal and rounds some codes the other way) and
  ``w4a8_matmul_xla`` at groups of 128, 64 and 32, M 1, 64, 65 and 200,
  K of 192 and 320 (no multiple of 128: the last block's zero-filled steps
  run as the kernels run them), and weights with groups of one sign (zero
  points outside [0, 15]). Weights packed by hand with zero points outside
  the code range at K 320 (g 64) and 352 (decode, 352 % 64 == 32), against
  the port's plain version. The split steps at g 120, 100 and 33, at
  decode and prefill, against the plain version and the JAX
  ``_w4a8_kernel`` (u8 half planes) in interpret mode on the same int8
  rows, at the card's gate, and the split step's two planted faults (the
  second issue dropped; the fold and second issue a step late) missing it.
- ``pack_w4``'s zero point: weights whose ``quantize_stacked`` zeros
  lie near -31,000, -300 and above 2,064 (nearly constant groups), under
  rows of one value, where a group's zero term cancels against its
  neighbour's: the port's plain versions against ``w4a16_matmul_xla``,
  ``_w4_kernel_q4`` and ``_w4a8_kernel_q4`` in interpret mode at the card's
  gate. An older layout, z - 8 rounded to bf16 again, misses it by far.
- The codes and zero points every weight source of the port gives:
  ``quantize_stacked`` and the AWQ / GPTQ import keep c - z in [-16, 15]
  wherever a group spans 0, so a 128-deep span's i32 dot stays below 2**22
  (the kernels' exact i32 -> f32 conversion); ``quantize_stacked`` gives a
  group of one sign a zero outside that range, which the kernels' rest term
  covers.
- ``w4_matmul.w4a8_plan`` at every shape ``chip_smoke.py`` checks and
  times: each (output tile, k block) falls to exactly one CTA, Llama-3.2-1B's
  decode shapes launch at least one CTA an SM, the workspace is what the
  kernels' indexing reaches; GPT-OSS's groups (120 and 100) take the
  wgmma kernels too, groups below 32 the mma.sync kernel (no plan).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from scratchpad_tpu.ops.quant import import_hf as jax_import_hf
from scratchpad_tpu.ops.quant.pallas_w4 import _w4a8_kernel, _w4a8_kernel_q4, to_4bit, w4_matmul_4bit
from scratchpad_tpu.ops.quant.w4a16 import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.ops.quant.w4a16 import slice_layer, w4a8_matmul_xla, w4a16_matmul_xla
from scratchpad_tpu_torch.executor.weight_loader import quantized_layer_state
from scratchpad_tpu_torch.ops.quant import import_hf
from scratchpad_tpu_torch.ops.quant import w4_matmul as wm
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked, stacked_group_size, stacked_out_width

ATOL, RTOL = 1e-4, 2.0**-8  # chip_smoke.py's kernel-vs-plain gate
I32_EXACT = 2**22  # |D| below this converts to f32 exactly (the 1.5 * 2**23 trick)
SPAN_FREE = 2048  # the widest group whose i32 sum stays below I32_EXACT (kSpanFree)


def _gate(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _fma32(a, b, c):
    """f32 fma: a * b + c rounded once (exact in f64 for these operands)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _zero_split(z: np.ndarray):
    """(zc, r) of stored zeros z (the zero points, as ``QuantizedLinear.z``
    holds them): the zero point rounded and clamped to [0, 16], and r = zc -
    z in f32."""
    zf = z.astype(np.float32)
    zc = np.clip(np.rint(zf), 0, 16).astype(np.float32)
    return zc, (zc - zf).astype(np.float32)


def w4a8_emulate(x8, ax, gsum, q, s, z, group_size, out_features, plan, fault=None):
    """bf16 ``[M, out_features]`` as the W4A8 kernels sum it (see the module
    docstring), on the plan's splits of ``plan.k_block``-deep blocks. It
    runs the kernels' own 32-deep steps, those past In that fill the last
    block included: there x and the codes are zeros and the group is the
    last one (the kernels' clamp), and a step that would end a group adds
    no rest. A step that holds a group edge (``step_cut``) is issued twice,
    on the codes before the edge (the others zero) and on those from it,
    the first group folded between; the i32 sum restarts where the
    kernels' ``accumulate`` flag says so, and a fold does not clear it.
    ``fault`` plants a fault of a split step: ``"drop_second"`` never issues
    the second slice, ``"fold_late"`` takes the fold and the second issue
    one step late (the next step's second slice, zero where that step holds
    no edge)."""
    M = x8.shape[0]
    g, G = group_size, s.shape[0]
    In = G * g
    Kb = plan.k_blocks * plan.k_block  # the k the blocks span, zeros past In
    nib = wm.unpack_w4(q, In)[:, :out_features].numpy().astype(np.int64) + 8  # [In, N]
    nib = np.pad(nib, ((0, Kb - In), (0, 0)), constant_values=8)
    zc, rest = _zero_split(z[:, :out_features].float().numpy())
    sf = s[:, :out_features].float().numpy()
    xi = np.pad(x8[:, :In].numpy().astype(np.int64), ((0, 0), (0, Kb - In)))
    gs = gsum.numpy()
    y = None
    for split in range(plan.splits):
        b0, b1 = plan.k_range(split)
        steps = range(b0 * plan.k_block // 32, b1 * plan.k_block // 32)
        tot = np.zeros((M, out_features), np.float32)
        d = np.zeros((M, out_features), np.int64)

        def fold(gi, j, group_end):
            nonlocal tot
            assert np.abs(d).max() < I32_EXACT
            inner = d.astype(np.float32)
            if group_end and 32 * j < In:
                inner = _fma32(gs[:, gi : gi + 1], rest[gi], inner)
            tot = _fma32(inner, sf[gi], tot)

        for j in steps:
            sl = slice(32 * j, 32 * j + 32)
            glo, ghi = min(32 * j // g, G - 1), min((32 * j + 32) // g, G - 1)
            cut = wm.step_cut(j, g, 32) if g % 32 else 0  # where the conversion splits the step
            lo, hi = nib[sl] - zc[glo].astype(np.int64), np.zeros((32, out_features), np.int64)
            assert lo.min() >= -16 and lo.max() <= 15
            if cut:
                lo[cut:] = 0
                hi = nib[sl] - zc[ghi].astype(np.int64)
                hi[:cut] = 0
            sched = cut  # where the kernels fold and issue the second slice
            if fault == "fold_late" and g % 32:
                sched = wm.step_cut(j - 1, g, 32)
            span = g % 128 == 0 or g > SPAN_FREE  # a fold every 128 k
            if j == steps[0] or 32 * j % g == 0 or (span and j % 4 == 0):
                d = np.zeros((M, out_features), np.int64)
            d = d + xi[:, sl] @ lo
            end = j == steps[-1] or 32 * (j + 1) % g == 0 or (span and (j + 1) % 4 == 0)
            if sched or end:
                fold(glo, j, bool(sched) or 32 * (j + 1) % g == 0)
            if sched and fault != "drop_second":
                d = xi[:, sl] @ hi
                if end:
                    fold(ghi, j, False)
        y = tot if y is None else (y + tot).astype(np.float32)
    return torch.from_numpy((y * ax.numpy()).astype(np.float32)).to(torch.bfloat16)


def _w4a8_kernel_q4_on(x8, ax, gsum, jq):
    """``_w4a8_kernel_q4`` in interpret mode on the given int8 rows, with
    ``_w4_q4_call``'s block specs (one row block, 128-column blocks)."""
    q4 = to_4bit(jq)
    B, In = x8.shape[0], q4.q4.shape[1] * 2
    Out, G = q4.q4.shape[2], q4.s.shape[1]
    in_specs = [
        pl.BlockSpec((B, In), lambda r, o, l: (r, 0)),
        pl.BlockSpec((B, 1), lambda r, o, l: (r, 0)),
        pl.BlockSpec((B, G), lambda r, o, l: (r, 0)),
        pl.BlockSpec((1, In // 2, 128), lambda r, o, l: (l[0], 0, o)),
        pl.BlockSpec((1, G, 128), lambda r, o, l: (l[0], 0, o)),
        pl.BlockSpec((1, G, 128), lambda r, o, l: (l[0], 0, o)),
    ]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1, Out // 128), in_specs=in_specs,
        out_specs=pl.BlockSpec((B, 128), lambda r, o, l: (r, o)),
    )
    y = pl.pallas_call(
        jax.tree_util.Partial(_w4a8_kernel_q4, group_size=q4.group_size), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B, Out), jnp.float32), interpret=True,
    )(jnp.zeros((1,), jnp.int32), jnp.asarray(x8[:, :In].numpy()), jnp.asarray(ax.numpy()),
      jnp.asarray(gsum.numpy()), q4.q4, q4.s, q4.z)
    return y[:, : q4.out_true] if q4.out_true else y


def _pair(In, Out, M, group, seed, one_sign=False):
    """The same weights quantized by both packages (with ``one_sign``, some
    groups of one sign: zero points outside [0, 15]), and bf16 activations
    (as f32 numpy) with a zero row."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    if one_sign:
        w[0, :group, :5] = np.abs(w[0, :group, :5]) + 0.01
        w[0, group:, 5:9] = -np.abs(w[0, group:, 5:9]) - 0.02
    x = _bf16(rng.normal(size=(M, In)))
    x[M // 2] = 0.0
    jq = jax_quantize_stacked(w, group)
    q, s, z = wm.pack_w4(quantize_stacked(w, group))
    return jq, (q[0], s[0], z[0]), x


# (In, Out, M, group asked of quantize_stacked, groups of one sign):
# decode (M 1 and 64: token tiles of 8 and 64, K split) and prefill (65,
# 200: 128 x 128 tiles, K split); a padded Out (320 -> 384); groups of 64 and
# 32 (folds inside a k block); K 192 and 320, no multiple of 128, whose
# last block has zero-filled steps that end no group, with groups of one
# sign at prefill (320, g 32; HAND_REST_CASES has the others)
W4A8_CASES = [
    (256, 256, 1, 128, False), (512, 320, 64, 128, False), (256, 192, 65, 128, True),
    (384, 256, 200, 64, False), (256, 128, 64, 64, True), (320, 256, 200, 32, False),
    (192, 128, 1, 32, False), (320, 192, 65, 32, True), (320, 128, 200, 32, True),
]


@pytest.mark.parametrize("In,Out,M,group,one_sign", W4A8_CASES)
def test_w4a8_kernel_arithmetic_meets_the_gate(In, Out, M, group, one_sign):
    jq, (q, s, z), x = _pair(In, Out, M, group, seed=In + M, one_sign=one_sign)
    g, out_f = jq.group_size, jq.out_features or Out
    assert g == group
    plan = wm.w4a8_plan(M, out_f, In, g, s.shape[1])
    assert plan is not None and plan.splits > 1  # the cases exercise split K
    x8, ax, gsum = wm.quantize_activations_plain(torch.from_numpy(x).to(torch.bfloat16), g)
    emu = w4a8_emulate(x8, ax, gsum, q, s, z, g, out_f, plan).float().numpy()
    refs = {
        "_w4a8_kernel_q4": _w4a8_kernel_q4_on(x8, ax, gsum, jq),
        "w4a8_matmul_xla": w4a8_matmul_xla(jnp.asarray(x), slice_layer(jq, 0)),
    }
    for name, ref in refs.items():
        assert _gate(emu, ref) <= 1.0, name
    assert not emu[M // 2].any()
    if one_sign:  # the rest term is in use
        _, rest = _zero_split(z[:, :out_f].float().numpy())
        assert np.abs(rest).max() > 0


# (In, Out, M, group) of weights packed by hand, with zero points outside
# the code range at a K that quantize_stacked's groups never reach: 320
# with g 64 at prefill (the last block's steps 10 and 11 are zeros; step 11
# would end a group), 352 with g 32 at decode (352 % 64 == 32); and
# chip_smoke.py's W4_ZERO_RESTS, narrowed
HAND_REST_CASES = [(320, 128, 65, 64), (320, 128, 200, 32), (352, 128, 5, 32), (352, 128, 64, 32)]


@pytest.mark.parametrize("In,Out,M,group", HAND_REST_CASES)
def test_w4a8_zero_rest_is_added_once_past_k(In, Out, M, group):
    """Integral zero points from -8 to 24 (as chip_smoke.py's W4_REST_ZEROS)
    on random codes: the emulation, which runs the last block's zero-filled
    steps, against the port's plain version (the JAX package's planes hold
    no group that straddles In / 2, so it has no such weight)."""
    rng = np.random.default_rng(In + M + group)
    G = In // group
    q = torch.from_numpy(rng.integers(0, 256, (Out, wm.padded_in(In) // 2), dtype=np.uint8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (G, Out)).astype(np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.integers(-8, 25, (G, Out)).astype(np.float32)).to(torch.bfloat16)
    x = _bf16(rng.normal(size=(M, In)))
    x[M // 2] = 0.0
    x8, ax, gsum = wm.quantize_activations_plain(torch.from_numpy(x).to(torch.bfloat16), group)
    plan = wm.w4a8_plan(M, Out, In, group, Out)
    assert plan.k_blocks * plan.k_block > In  # zero-filled steps run
    emu = w4a8_emulate(x8, ax, gsum, q, s, z, group, Out, plan).float().numpy()
    ref = wm.w4a8_matmul_plain(x8, ax, gsum, q, s, z, group, Out).numpy()
    assert _gate(emu, ref) <= 1.0
    assert not emu[M // 2].any()
    _, rest = _zero_split(z.float().numpy())
    assert np.abs(rest[-1]).max() > 0  # the last group has rests


def _codes_minus_zero(q, z, In, group):
    nib = wm.unpack_w4(q, In).numpy().astype(np.int64) + 8
    zero = z.float().numpy().astype(np.float64)
    return nib - np.repeat(zero, group, axis=0), zero


def test_quantized_weights_that_span_zero_keep_c_minus_z_in_s8():
    """quantize_stacked on weights whose every group spans 0 (random normal,
    skewed, with outliers, a zero column): integral zero points in [0, 15],
    c - z in [-16, 15], a 128-deep span's i32 dot below 2**22."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 512, 256)).astype(np.float32)
    w[1] = w[1] * 0.01 + 0.02 * np.abs(rng.normal(size=w[1].shape))  # skewed positive
    w[1, ::16] = -1.0  # ... but every group holds a negative weight
    w[2, ::97] *= 50.0  # outliers
    w[2, :, 3] = 0.0  # a zero column
    for group in (128, 64, 32):
        ql = quantize_stacked(w, group)
        q, _, z = wm.pack_w4(ql)
        for l in range(w.shape[0]):
            cz, zero = _codes_minus_zero(q[l], z[l], w.shape[1], ql.group_size)
            assert np.array_equal(zero, np.rint(zero)) and zero.min() >= 0 and zero.max() <= 15
            assert cz.min() >= -16 and cz.max() <= 15
            assert 127 * np.abs(cz).max() * min(ql.group_size, 128) < I32_EXACT


def test_a_group_of_one_sign_gets_a_zero_outside_the_code_range():
    """Why the kernels carry the rest term: quantize_stacked (the JAX
    package's formula, round(-wmin / scale)) gives a group of one sign a
    zero point below 0 or above 15, and a constant column one of about
    -5e7, in both packages."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(1, 256, 16)).astype(np.float32) * 0.02
    w[0, :128, 0] = np.abs(w[0, :128, 0]) + 0.01
    w[0, 128:, 1] = -np.abs(w[0, 128:, 1]) - 0.01
    w[0, :, 2] = 0.5
    zero = quantize_stacked(w).z.float().numpy()[0]
    assert zero[0, 0] < 0 and zero[1, 1] > 15 and zero[0, 2] < -1e6
    np.testing.assert_array_equal(zero, np.asarray(jax_quantize_stacked(w).z, np.float32)[0])


@pytest.mark.parametrize("method", ["awq", "gptq", "gptq_v2"])
def test_imported_checkpoints_keep_c_minus_z_in_s8(method):
    """Every code and every zero nibble an AutoAWQ / AutoGPTQ checkpoint can
    hold (GPTQ v1's zeros 1..16), imported: c - z in [-16, 15]."""
    In, Out, g = 128, 64, 32
    q = np.tile(np.arange(16, dtype=np.uint8), (In, Out // 16)) ^ (np.arange(In)[:, None] % 16).astype(np.uint8)
    lo, hi = (1, 17) if method == "gptq" else (0, 16)
    z = (np.arange(In // g * Out).reshape(In // g, Out) % (hi - lo) + lo).astype(np.float32)
    s = np.full((In // g, Out), 0.01, np.float16)
    if method == "awq":
        qw, qz, sc = jax_import_hf.pack_awq(q, z, s)
    else:
        qw, qz, sc = jax_import_hf.pack_gptq(q, z, s, v2=method == "gptq_v2")
    quant = {"model.layers.0.mlp.down_proj.qweight": qw, "model.layers.0.mlp.down_proj.qzeros": qz,
             "model.layers.0.mlp.down_proj.scales": sc}
    layers_q = import_hf.convert_quantized_layers(quant, 1, "awq" if method == "awq" else "gptq",
                                                  gptq_v2=method == "gptq_v2")
    state = quantized_layer_state(layers_q)
    cz, zero = _codes_minus_zero(state["layers.0.down.q"], state["layers.0.down.z"], In, g)
    assert zero.min() == lo and zero.max() == hi - 1
    assert cz.min() >= -16 and cz.max() <= 15
    assert {int(v) for v in np.unique(cz)} >= set(range(-15, 15 - (1 if method == "gptq" else 0) + 1))


# ------------------------------------------------------------------ launch plan


def _w4a8_shapes():
    """(label, M, N, K, group, stored width) of every W4A8 call
    chip_smoke.py checks and times."""
    mats = {name: (In, Out) for name, In, Out, _ in chip_smoke.llama_1b_matrices()}
    ms = sorted(set(chip_smoke.W4_CHECK_M) | {64, 8192})
    out = [(f"{n} M={M}", M, Out, In, stacked_group_size(In), stacked_out_width(Out)[0])
           for n, (In, Out) in mats.items() for M in ms]
    out += [(f"{n} g={g} M={M}", M, mats[n][1], mats[n][0], g, stacked_out_width(mats[n][1])[0])
            for n, g, m_list in chip_smoke.W4_SMALL_GROUPS for M in m_list]
    out += [(f"{n} g={g} M={M}", M, Out, In, g, stacked_out_width(Out)[0])
            for n, In, Out, g, m_list in chip_smoke.W4_ZERO_RESTS for M in m_list]
    for name, In, Out, ms in (("gpt-oss gate_up", 2880, 5760, (1, 64, 300, 8192)), ("g100", 1800, 1000, (1, 64, 300)),
                              *chip_smoke.W4_STACKED_FAR):
        out += [(f"{name} M={M}", M, Out, In, stacked_group_size(In), stacked_out_width(Out)[0]) for M in ms]
    out += [(f"{n} g={g} M={M}", M, Out, In, g, stacked_out_width(Out)[0])
            for n, In, Out, g, m_list in chip_smoke.W4_MMA_GROUPS + chip_smoke.W4A16_MMA_GROUPS
            for M in m_list]
    return out


def _kernel_workspace_bytes(plan) -> int:
    """The bytes the split-K indexing reaches (sm90_gemm.cuh's splitk_sum:
    the counters, then chunk ((z m_tiles + y) n_tiles + x) splits + split of
    rows x BN f32; the decode kernel's grid has one row of tiles)."""
    if plan.splits == 1:
        return 0
    bm, bn = plan.tile
    last_chunk = (plan.m_tiles * plan.n_tiles - 1) * plan.splits + plan.splits - 1
    return wm.COUNTER_SLOTS * 4 + (last_chunk + 1) * bm * bn * 4


@pytest.mark.parametrize("label,M,N,K,group,width", _w4a8_shapes())
def test_w4a8_plan_covers_every_tile_once(label, M, N, K, group, width):
    plan = wm.w4a8_plan(M, N, K, group, width)
    if group < 32:  # the mma.sync kernel's remainder
        assert plan is None
        return
    bm, bn = plan.tile  # GPT-OSS's groups too: split steps
    if M > 64:
        assert (plan.config, plan.k_block, bm, bn) == (0, 128, 128, 128)
    else:  # swap-AB: the tokens rounded up to the wgmma N, in two tiles of 32 for a small matrix
        assert (plan.config, plan.k_block, bn) == (3, 64, 64)
        rounded = min(t for t in wm.DECODE_TOKENS if t >= M)
        small = -(-N // 64) * -(-K // 64) <= wm.SPLIT_TOKENS
        assert bm == (32 if rounded == 64 and small else rounded)
    assert (plan.m_tiles - 1) * bm < M <= plan.m_tiles * bm
    assert (plan.n_tiles - 1) * bn < N <= plan.n_tiles * bn
    blocks = [b for i in range(plan.splits) for b in range(*plan.k_range(i))]
    assert blocks == list(range(plan.k_blocks)) and plan.k_blocks == -(-K // plan.k_block)
    assert all(plan.k_range(i)[1] > plan.k_range(i)[0] for i in range(plan.splits))
    assert plan.workspace_bytes == _kernel_workspace_bytes(plan) <= wm.WORKSPACE_BYTES
    assert plan.splits == 1 or plan.m_tiles * plan.n_tiles <= wm.COUNTER_SLOTS
    if M in (1, 64) and "g=" not in label:  # Llama-3.2-1B decode: one CTA an SM at least
        assert plan.ctas >= wm.SMS, plan


def _small_a8(M, In, Out, group, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 256, (Out, wm.padded_in(In) // 2), dtype=np.uint8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (In // group, Out)).astype(np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.integers(0, 16, (In // group, Out)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(_bf16(rng.normal(size=(M, In)))).to(torch.bfloat16)
    return (*wm.quantize_activations_plain(x, group), q, s, z)


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows", wm.DECODE_TOKENS)
def test_w4a8_decode_plans_of_the_sweep_fit_the_kernel(rows, splits):
    """tools/gemm_ab.py's sweep: a decode plan at any token tile and K split
    covers each (tile, k block) once, and ``w4a8_matmul_with_plan`` takes
    it (the plain version on the CPU)."""
    M, In, Out = 40, 512, 320
    plan = wm.w4a8_decode_plan(M, Out, In, rows, splits)
    assert plan.splits == min(splits, plan.k_blocks) and plan.tile == (rows, 64)
    assert [b for i in range(plan.splits) for b in range(*plan.k_range(i))] == list(range(plan.k_blocks))
    args = _small_a8(M, In, Out, 32, seed=rows + splits)
    got = wm.w4a8_matmul_with_plan(*args, 32, Out, plan)
    assert torch.equal(got, wm.w4a8_matmul_plain(*args, 32, Out))


def test_w4a8_matmul_with_plan_refuses_a_plan_that_does_not_fit():
    """A plan of another M, tile, width or depth, more splits than k
    blocks, or a group below 32 (the mma.sync kernel's): refused before a
    launch."""
    M, In, Out = 40, 512, 320
    args = _small_a8(M, In, Out, 32, seed=0)
    own = wm.w4a8_plan(M, Out, In, 32, Out)
    wrong = [
        wm.w4a8_plan(100, Out, In, 32, Out),  # a prefill plan
        wm.gemm_plan(M, Out, In),  # the bf16 mainloop's
        wm.w4a8_decode_plan(M, 2 * Out, In, 64),
        wm.w4a8_decode_plan(M, Out, 2 * In, 64),
        dataclasses.replace(own, splits=own.k_blocks + 1),
        dataclasses.replace(own, rows=24),
    ]
    for plan in wrong:
        with pytest.raises(ValueError):
            wm.w4a8_matmul_with_plan(*args, 32, Out, plan)
    x8, ax, gsum, q, s, z = _small_a8(M, 480, Out, 24, seed=1)
    with pytest.raises(ValueError):
        wm.w4a8_matmul_with_plan(x8, ax, gsum, q, s, z, 24, Out, wm.w4a8_decode_plan(M, Out, 480, 64))
    with pytest.raises(ValueError):
        wm.w4a8_decode_plan(65, Out, In, 64)


# ------------------------------------------------------------------ split steps


def _w4a8_kernel_on(x8, ax, gsum, jq):
    """``_w4a8_kernel`` (u8 half planes, any group that divides In / 2) in
    interpret mode on the given int8 rows, with ``_w4a8_call``'s block specs
    (one row block, 128-column blocks)."""
    B, In = x8.shape[0], jq.in_features
    Out, G = jq.q.shape[2], jq.s.shape[1]
    in_specs = [
        pl.BlockSpec((B, In), lambda r, o, l: (r, 0)),
        pl.BlockSpec((B, 1), lambda r, o, l: (r, 0)),
        pl.BlockSpec((B, G), lambda r, o, l: (r, 0)),
        pl.BlockSpec((1, In // 2, 128), lambda r, o, l: (l[0], 0, o)),
        pl.BlockSpec((1, G, 128), lambda r, o, l: (l[0], 0, o)),
        pl.BlockSpec((1, G, 128), lambda r, o, l: (l[0], 0, o)),
    ]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1, Out // 128), in_specs=in_specs,
        out_specs=pl.BlockSpec((B, 128), lambda r, o, l: (r, o)),
    )
    y = pl.pallas_call(
        jax.tree_util.Partial(_w4a8_kernel, group_size=jq.group_size), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B, Out), jnp.float32), interpret=True,
    )(jnp.zeros((1,), jnp.int32), jnp.asarray(x8[:, :In].numpy()), jnp.asarray(ax.numpy()),
      jnp.asarray(gsum.numpy()), jq.q, jq.s, jq.z)
    return y[:, : jq.out_true] if jq.out_true else y


# (In, Out, M, group asked of quantize_stacked) of the groups that cut a
# 32-deep step: g 120 (three steps in 15 split; decode at K 480, prefill
# at K 240 with K inside a step), g 100 (seven in 25; K 200 inside a step:
# the last split step's second slice lies past K), and g 33, the least
# group of the split path (K 264 = 8 x 33); decode (token tiles of 8 and 32,
# K split) and prefill (128 x 128 tiles, K split)
W4A8_SPLIT_CASES = [(480, 256, 1, 128), (240, 192, 200, 128), (400, 128, 64, 128), (200, 256, 130, 128),
                    (264, 128, 5, 33), (264, 128, 65, 33)]


def _split_case(In, Out, M, group):
    jq, (q, s, z), x = _pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features or Out
    assert g % 32 and g >= 32
    plan = wm.w4a8_plan(M, out_f, In, g, s.shape[1])
    assert plan is not None and plan.splits > 1
    x8, ax, gsum = wm.quantize_activations_plain(torch.from_numpy(x).to(torch.bfloat16), g)
    return jq, (x8, ax, gsum, q, s, z), g, out_f, plan


@pytest.mark.parametrize("In,Out,M,group", W4A8_SPLIT_CASES)
def test_w4a8_split_steps_meet_the_gate(In, Out, M, group):
    """The split path's step schedule against the port's plain version and
    the JAX ``_w4a8_kernel`` on the same int8 rows, at the card's gate."""
    jq, args, g, out_f, plan = _split_case(In, Out, M, group)
    assert any(wm.step_cut(j, g, 32) for j in range(plan.k_blocks * plan.k_block // 32))
    emu = w4a8_emulate(*args, g, out_f, plan).float().numpy()
    refs = {"plain": wm.w4a8_matmul_plain(*args, g, out_f).numpy(), "_w4a8_kernel": _w4a8_kernel_on(*args[:3], jq)}
    for name, ref in refs.items():
        assert _gate(emu, ref) <= 1.0, name
    assert not emu[M // 2].any()


@pytest.mark.parametrize("fault", ["drop_second", "fold_late"])
@pytest.mark.parametrize("In,Out,M,group", [W4A8_SPLIT_CASES[2], W4A8_SPLIT_CASES[3]])
def test_w4a8_split_step_faults_exceed_the_gate(In, Out, M, group, fault):
    """What the card checks would see of a faulty split step: the second
    issue dropped, or the fold and the second issue a step late."""
    _, args, g, out_f, plan = _split_case(In, Out, M, group)
    emu = w4a8_emulate(*args, g, out_f, plan, fault=fault).float().numpy()
    assert _gate(emu, wm.w4a8_matmul_plain(*args, g, out_f).numpy()) > 1.0


# ------------------------------------------------------------------ pack_w4's zero point


def _far_zero_weights(In, Out, group, seed):
    """Weights [1, In, Out] whose first columns pair a nearly constant group
    of c = 0.5 (zero point about -31,000 in col 0 and 2, -300 in col 1) with
    one of -c (zero point about 2,070), the rest N(0, 1/In); and rows of x:
    random, a zero row, and rows of one value, under which each pair's two
    groups cancel."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    g = stacked_group_size(In, group)
    c = 0.5
    for col, g0, zero_pos in ((0, 0, 31000.0), (1, 0, 300.0), (2, 2, 31000.0)):
        up = c + rng.uniform(0, 1, g) * 15 * c / zero_pos
        up[:2] = c, c + 15 * c / zero_pos  # the group's range, pinned
        down = -c - rng.uniform(0, 1, g) * 15 * c / 2055.0
        down[:2] = -c, -c - 15 * c / 2055.0
        w[0, g0 * g:(g0 + 1) * g, col] = up
        w[0, (g0 + 1) * g:(g0 + 2) * g, col] = down
    x = _bf16(rng.normal(size=(9, In)))
    x[4] = 0.0
    x[6], x[7], x[8] = 1.0, -0.5, 3.0
    return w, x


@pytest.mark.parametrize("In,Out,group", [(512, 256, 128), (480, 256, 120)])
def test_zero_points_far_outside_the_code_range_match_jax(In, Out, group):
    """``pack_w4`` stores the zero point as the JAX package's bf16 z, and the
    plain versions take z - 8 in f32 as its ``to_4bit`` does: W4A16 against
    ``w4a16_matmul_xla`` and ``_w4_kernel_q4`` (on f32 rows holding bf16
    values, where both stay in f32), W4A8 against ``_w4a8_kernel_q4`` on the
    port's int8 rows, at the card's gate."""
    w, x = _far_zero_weights(In, Out, group, seed=In)
    jq = jax_quantize_stacked(w, group)
    zero = np.asarray(jq.z, np.float32)[0]
    assert zero[0, 0] < -30000 and -320 < zero[0, 1] < -280 and zero[1, 0] >= 2064 and zero[2, 2] < -30000
    q, s, z = (t[0] for t in wm.pack_w4(quantize_stacked(w, group)))
    np.testing.assert_array_equal(z.float().numpy(), zero)  # the JAX bf16 zero, unshifted
    g, out_f = jq.group_size, jq.out_features or Out
    xt = torch.from_numpy(x)
    y16 = wm.w4a16_matmul_plain(xt, q, s, z, g, out_f).numpy()
    refs = {
        "w4a16_matmul_xla": w4a16_matmul_xla(jnp.asarray(x), slice_layer(jq, 0)),
        "_w4_kernel_q4": w4_matmul_4bit(jnp.asarray(x), to_4bit(jq), jnp.int32(0), a8=False, out_block=128),
    }
    for name, ref in refs.items():
        assert _gate(y16, ref) <= 1.0, name
    x8, ax, gsum = wm.quantize_activations_plain(xt.to(torch.bfloat16), g)
    y8 = wm.w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, out_f).numpy()
    assert _gate(y8, _w4a8_kernel_q4_on(x8, ax, gsum, jq)) <= 1.0
    assert not y16[4].any() and not y8[4].any()
