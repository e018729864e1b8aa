"""The Hopper GEMMs' launch plan and arithmetic, on the CPU.

- A plain emulation of the arithmetic of ``csrc/w4a16_matmul.cu`` and
  ``csrc/delta_matmul.cu`` (the mainloop of ``csrc/sm90_gemm.cuh``) against
  the JAX package's functions on the same numpy-seeded inputs, at the card's
  gate |emu - ref| <= 1e-4 + 2**-8 |ref|. W4A16: the zero point clamped to
  [0, 16] and folded into the code (nibble - zc, exact), f32 sums over the
  kernel's 16-deep steps folded with the group's scale at each group end
  and at each split's end, with the clamp's rest (the f32 sum of x over the
  fold's span times zc - z) added at the fold, the splits' partials added
  in the plan's order, one bf16 rounding; held against ``w4a16_matmul_xla``
  and ``_w4_kernel_q4`` in interpret mode, also on ``quantize_stacked``'s
  groups of one sign and a constant column (zero points far outside the
  code range), where an older kernel's c - z in bf16 misses the gate. At
  groups that cut a 16-deep step (GPT-OSS's 120 and 100, and 17, the least
  odd group of the split path): each step that holds a group edge issued
  twice, the first group folded between the two, the steps past K that
  fill the last block run; held against the port's plain version and the
  JAX ``_w4_kernel`` (``w4a16_matmul_pallas``) in interpret mode on f32
  rows that hold bf16 values, where its z·s stays f32 (on bf16 rows it
  rounds z·s to bf16, ``pallas_w4.py:46,73``, a change of y of up to
  2**-9 sum_g |xsum_g z_g s_g|, outside the card's gate), both at the card's
  gate. The split step's two planted faults (the second issue dropped; the
  fold and second issue a step late) miss it. The delta:
  f32 block sums added in order, split partials likewise, then
  ``bf16(f32(out) + acc * ds * scaling)`` on the slot's rows; held against
  ``out + delta_matmul_xla``. The same emulation with the weight rounded to
  bf16 first (``(c - z) * s``, ``dq * ds``) exceeds the gate, which is why
  the kernels keep every scale out of the product.
- ``w4_matmul.gemm_plan`` at every shape ``chip_smoke.py`` times and checks:
  each (output tile, k block) falls to exactly one CTA, Llama-3.2-1B's decode
  shapes launch at least one CTA an SM, and the workspace is what the
  kernel's indexing reaches.
- ``utils/native.py``: an edited ``csrc/*.cuh`` header changes every
  library's path, so a stale library is never loaded (a copy of ``csrc``,
  no ``nvcc``).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from scratchpad_tpu.ops import ldmm as jax_ldmm
from scratchpad_tpu.ops.quant.pallas_w4 import to_4bit, w4_matmul_4bit, w4a16_matmul_pallas
from scratchpad_tpu.ops.quant.w4a16 import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.ops.quant.w4a16 import slice_layer, w4a16_matmul_xla
from scratchpad_tpu_torch.ops.quant import w4_matmul as wm
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked, stacked_group_size
from scratchpad_tpu_torch.utils import native

ATOL, RTOL = 1e-4, 2.0**-8  # chip_smoke.py's kernel-vs-plain gate
K_BLOCK = wm.K_BLOCK


def _gate(got, ref) -> float:
    """Worst |got - ref| / (ATOL + RTOL |ref|): at most 1 passes."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ W4A16


def w4a16_emulate(x, q, s, z, group_size, out_features, plan, dequant_bf16=False, bf16_code=False,
                  fault=None):
    """bf16 ``[M, out_features]`` as the kernel sums it (see the module
    docstring), step by step over each split's 16-deep steps, those past In
    that fill the last block included (x and the codes zero there, the
    group the last one). A step that holds a group edge (``step_cut``, a
    group that is no multiple of 16) is issued twice, on a slice of the
    codes before the edge (the first group's zero) and one of those from it
    (the next group's), each zero elsewhere, the first group folded between
    the two; the accumulator restarts where the kernel's ``accumulate`` flag
    says so, and a fold does not clear it. ``dequant_bf16`` rounds ``(nibble
    - z) * s`` to bf16 first and sums the plain products instead;
    ``bf16_code`` forms c - z as an older kernel did, one bf16 subtraction
    of 136 + bf16(z - 8), with no rest. ``fault`` plants a fault of a split
    step: ``"drop_second"`` never issues the second slice, ``"fold_late"``
    takes the fold and the second issue one step late (the next step's
    second slice, zero where that step holds no edge)."""
    M, In = x.shape
    g, G, N = group_size, In // group_size, out_features
    Kb = plan.k_blocks * K_BLOCK
    xf = F.pad(x.float(), (0, Kb - In))
    nib = F.pad(wm.unpack_w4(q, In)[:, :N].float() + 8.0, (0, 0, 0, Kb - In), value=8.0)  # [Kb, N], 0..15
    zf = z[:, :N].float()
    zc = torch.clamp(torch.round(zf), 0.0, 16.0)  # the clamped zero point
    rest = zc - zf  # zero where the zero point is in range
    sf = s[:, :N].float()
    if dequant_bf16:
        sf, rest = torch.ones_like(sf), torch.zeros_like(rest)
    if bf16_code:
        sub = _bf16_t(136.0 + _bf16_t(zf - 8.0))
        rest = torch.zeros_like(rest)

    def codes(k0, gi):  # the 16 codes of the step at k0 less group gi's zero, as the B tile holds them
        c = nib[k0:k0 + 16]
        if dequant_bf16:
            return ((c - zf[gi]) * s[gi, :N].float()).to(torch.bfloat16).float()
        if bf16_code:
            return _bf16_t(_bf16_t(128.0 + c) - sub[gi])
        return c - zc[gi]

    y = None
    for split in range(plan.splits):
        b0, b1 = plan.k_range(split)
        steps = range(b0 * K_BLOCK // 16, b1 * K_BLOCK // 16)
        tot, acc, xs = torch.zeros(M, N), torch.zeros(M, N), torch.zeros(M, 1)

        def fold(gi, j):
            nonlocal tot, xs
            r = rest[gi] if 16 * j < In else torch.zeros_like(rest[gi])
            tot = tot + (acc + xs * r) * sf[gi]
            xs = torch.zeros(M, 1)

        for j in steps:
            k0 = 16 * j
            xj = xf[:, k0:k0 + 16]
            glo, ghi = min(k0 // g, G - 1), min((k0 + 16) // g, G - 1)
            cut = wm.step_cut(j, g, 16) if g % 16 else 0  # where the conversion splits the step
            lo, hi = codes(k0, glo), torch.zeros(16, N)
            if cut:
                lo[cut:] = 0.0
                hi = codes(k0, ghi)
                hi[:cut] = 0.0
            sched = cut  # where the mainloop folds and issues the second slice
            if fault == "fold_late" and g % 16:
                sched = wm.step_cut(j - 1, g, 16)
            if j == steps[0] or k0 % g == 0:
                acc = torch.zeros(M, N)
            acc = acc + xj @ lo
            xs = xs + xj[:, : sched or 16].sum(1, keepdim=True)
            end = j == steps[-1] or (k0 + 16) % g == 0
            if sched or end:
                fold(glo, j)
            if sched and fault != "drop_second":
                acc = xj @ hi
                xs = xs + xj[:, sched:].sum(1, keepdim=True)
                if end:
                    fold(ghi, j)
        y = tot if y is None else y + tot
    return y.to(torch.bfloat16)


def _bf16_t(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _w4_pair(In, Out, M, group, seed):
    """The same weights quantized by both packages, and bf16 activations
    (as f32 numpy) with a zero row."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    x = _bf16(rng.normal(size=(M, In)))
    x[M // 2] = 0.0
    jq = jax_quantize_stacked(w, group)
    q, s, z = wm.pack_w4(quantize_stacked(w, group))
    return jq, (q[0], s[0], z[0]), x


# (In, Out, M, group asked of quantize_stacked): decode-sized and
# prefill-sized rows (64 x 64 and 128 x 128 tiles, K split into 4, 3 or 8
# parts), a padded Out (out_true 192) and group 96 (In 384's half-plane
# rule), groups of 64 and of 32 (96 and 32 fold inside a 64-deep block)
W4_CASES = [(256, 256, 8, 128), (384, 192, 80, 128), (256, 128, 64, 64), (512, 128, 3, 32)]


@pytest.mark.parametrize("In,Out,M,group", W4_CASES)
def test_w4a16_kernel_arithmetic_meets_the_gate(In, Out, M, group):
    jq, (q, s, z), x = _w4_pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features
    plan = wm.w4a16_plan(M, out_f, In, g, s.shape[1])
    assert plan is not None and plan.splits > 1  # the cases exercise split K
    emu = w4a16_emulate(torch.from_numpy(x), q, s, z, g, out_f, plan).float().numpy()
    refs = {
        "w4a16_matmul_xla": w4a16_matmul_xla(jnp.asarray(x), slice_layer(jq, 0)),
        "_w4_kernel_q4": w4_matmul_4bit(jnp.asarray(x), to_4bit(jq), jnp.int32(0), a8=False, out_block=128),
    }
    for name, ref in refs.items():
        assert _gate(emu, ref) <= 1.0, name
    assert not emu[M // 2].any()


def _w4_rest_pair(In, Out, M, group, seed):
    """``_w4_pair`` with groups of one sign, a constant column and nearly
    constant ones, whose zero points ``quantize_stacked`` puts outside [0,
    15] (about -5e7 for the constant one, -500 to -2,000 for the nearly
    constant ones, whose codes still vary)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    g = stacked_group_size(In, group)
    w[0, :g, :7] = np.abs(w[0, :g, :7]) + 0.01
    w[0, g:, 7:13] = -np.abs(w[0, g:, 7:13]) - 0.02
    w[0, :, 13] = 0.5
    w[0, :, 14:30] = 0.5 + 3e-2 * w[0, :, 14:30]  # nearly constant: zeros of -500 to -2,000
    x = _bf16(rng.normal(size=(M, In)))
    x[M // 2] = 0.0
    jq = jax_quantize_stacked(w, group)
    ql = quantize_stacked(w, group)
    assert float(ql.z.float().min()) < -1e6 and float(ql.z.float().max()) > 16
    q, s, z = wm.pack_w4(ql)
    return jq, (q[0], s[0], z[0]), x


# (In, Out, M, group asked of quantize_stacked): decode (64 x 64 tiles, K
# split) and prefill, group 128; In 224 (group 112: folds inside 64-deep
# blocks, the last block half past K)
W4_REST_CASES = [(512, 256, 8, 128), (512, 256, 80, 128), (224, 256, 8, 128), (224, 256, 130, 128)]


@pytest.mark.parametrize("In,Out,M,group", W4_REST_CASES)
def test_w4a16_zero_rests_meet_the_gate(In, Out, M, group):
    """Zero points outside the code range: the clamped code and the rest at
    the fold meet the gate against both JAX references; the parent's c - z
    in bf16 does not."""
    jq, (q, s, z), x = _w4_rest_pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features
    plan = wm.w4a16_plan(M, out_f, In, g, s.shape[1])
    assert plan is not None
    xt = torch.from_numpy(x)
    emu = w4a16_emulate(xt, q, s, z, g, out_f, plan).float().numpy()
    refs = {
        "w4a16_matmul_xla": w4a16_matmul_xla(jnp.asarray(x), slice_layer(jq, 0)),
        "_w4_kernel_q4": w4_matmul_4bit(jnp.asarray(x), to_4bit(jq), jnp.int32(0), a8=False, out_block=128),
    }
    for name, ref in refs.items():
        assert _gate(emu, ref) <= 1.0, name
    assert not emu[M // 2].any()
    parent = w4a16_emulate(xt, q, s, z, g, out_f, plan, bf16_code=True).float().numpy()
    assert _gate(parent, refs["w4a16_matmul_xla"]) > 1.0


# (In, Out, M, group asked of quantize_stacked) of the groups that cut a
# 16-deep step: g 120 (GPT-OSS's half-plane rule; one step in 15 split, K
# 480 at decode, 240 at prefill with K on a step's edge), g 100 (three in
# 25; K 200 inside a step, the last split step's second slice past K), and
# g 17, the least odd group of the split path (K 272 = 16 x 17)
W4_SPLIT_CASES = [(480, 256, 5, 128), (240, 192, 130, 128), (400, 128, 64, 128), (200, 256, 70, 128),
                  (272, 128, 3, 17), (272, 128, 65, 17)]


def _w4_split_pair(In, Out, M, group, seed):
    jq, qsz, x = _w4_pair(In, Out, M, group, seed)
    assert jq.group_size % 16 and jq.group_size >= 16
    return jq, qsz, x


@pytest.mark.parametrize("In,Out,M,group", W4_SPLIT_CASES)
def test_w4a16_split_steps_meet_the_gate(In, Out, M, group):
    """The split path's step schedule against the port's plain version and
    the JAX ``_w4_kernel`` (f32 rows holding bf16 values), at the card's
    gate; the plan splits K, and some split steps fold mid-block."""
    jq, (q, s, z), x = _w4_split_pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features or Out
    plan = wm.w4a16_plan(M, out_f, In, g, s.shape[1])
    assert plan is not None and plan.splits > 1
    cuts = [j for j in range(plan.k_blocks * K_BLOCK // 16) if wm.step_cut(j, g, 16)]
    assert cuts and all(0 < wm.step_cut(j, g, 16) < 16 for j in cuts)
    xt = torch.from_numpy(x)
    emu = w4a16_emulate(xt, q, s, z, g, out_f, plan).float().numpy()
    refs = {
        "plain": wm.w4a16_matmul_plain(xt, q, s, z, g, out_f).numpy(),
        "_w4_kernel": w4a16_matmul_pallas(jnp.asarray(x), jq, jnp.int32(0), out_block=128),
    }
    for name, ref in refs.items():
        assert _gate(emu, ref) <= 1.0, name
    assert not emu[M // 2].any()


@pytest.mark.parametrize("fault", ["drop_second", "fold_late"])
@pytest.mark.parametrize("In,Out,M,group", [W4_SPLIT_CASES[0], W4_SPLIT_CASES[3]])
def test_w4a16_split_step_faults_exceed_the_gate(In, Out, M, group, fault):
    """What the card checks would see of a faulty split step: the second
    issue dropped, or the fold and the second issue a step late."""
    jq, (q, s, z), x = _w4_split_pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features or Out
    plan = wm.w4a16_plan(M, out_f, In, g, s.shape[1])
    xt = torch.from_numpy(x)
    emu = w4a16_emulate(xt, q, s, z, g, out_f, plan, fault=fault).float().numpy()
    assert _gate(emu, wm.w4a16_matmul_plain(xt, q, s, z, g, out_f).numpy()) > 1.0


@pytest.mark.parametrize("In,Out,M,group", W4_CASES[:2])
def test_w4a16_weights_rounded_to_bf16_exceed_the_gate(In, Out, M, group):
    jq, (q, s, z), x = _w4_pair(In, Out, M, group, seed=In + M)
    g, out_f = jq.group_size, jq.out_features
    plan = wm.w4a16_plan(M, out_f, In, g, s.shape[1])
    emu = w4a16_emulate(torch.from_numpy(x), q, s, z, g, out_f, plan, dequant_bf16=True)
    ref = w4a16_matmul_xla(jnp.asarray(x), slice_layer(jq, 0))
    assert _gate(emu.float().numpy(), ref) > 1.0


# ------------------------------------------------------------------ delta


def delta_emulate(out, x, panel, ds_row, sc, rows, plan, dequant_bf16=False):
    """``out`` with the kernel's sum added on ``rows`` (see the module
    docstring); ``dequant_bf16`` rounds ``dq * ds`` to bf16 first."""
    T, In = x.shape
    xf, w = x.float(), panel.float()
    if dequant_bf16:
        w = (w * ds_row).to(torch.bfloat16).float()
    acc = None
    for split in range(plan.splits):
        b0, b1 = plan.k_range(split)
        part = torch.zeros(T, w.shape[1])
        for b in range(b0, b1):  # folded after every block
            sl = slice(b * K_BLOCK, min((b + 1) * K_BLOCK, In))
            part = part + xf[:, sl] @ w[sl]
        acc = part if acc is None else acc + part
    y = acc * sc if dequant_bf16 else acc * ds_row * sc
    res = (out.float() + y).to(torch.bfloat16)
    return torch.where(rows[:, None], res, out)


def _delta_case(T, In, Out, seed, N=4, L=2):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((T, In)))
    dq = rng.integers(-127, 128, (N, L, In, Out)).astype(np.int8)
    ds = (rng.random((N, L, Out)) * 2e-3).astype(np.float32)
    out = _bf16(rng.standard_normal((T, Out)))
    rows = rng.random(T) < 0.5
    return x, dq, ds, out, rows


# (T, In, Out): decode (64 x 64 tiles, K split), a 128-row tile with a
# partial last k block (In 208), an Out no tile width divides
DELTA_CASES = [(16, 256, 128), (70, 208, 192), (64, 512, 1000)]


@pytest.mark.parametrize("T,In,Out", DELTA_CASES)
def test_delta_kernel_arithmetic_meets_the_gate(T, In, Out):
    x, dq, ds, out, rows = _delta_case(T, In, Out, seed=T + In)
    aid, layer, sc = 2, 1, np.float32(1.5)
    plan = wm.gemm_plan(T, Out, In, slots=7)
    emu = delta_emulate(
        torch.from_numpy(out).to(torch.bfloat16), torch.from_numpy(x), torch.from_numpy(dq[aid, layer]),
        torch.from_numpy(ds[aid, layer]), float(sc), torch.from_numpy(rows), plan,
    ).float().numpy()
    mask_scale = jnp.asarray(rows * sc, jnp.float32)
    ref = out + np.asarray(
        jax_ldmm.delta_matmul_xla(jnp.asarray(x), jnp.asarray(dq), jnp.asarray(ds), jnp.int32(aid),
                                  jnp.int32(layer), mask_scale)
    )
    assert _gate(emu[rows], ref[rows]) <= 1.0
    assert np.array_equal(emu[~rows], out[~rows])


@pytest.mark.parametrize("T,In,Out", DELTA_CASES[:2])
def test_delta_rounded_to_bf16_exceeds_the_gate(T, In, Out):
    x, dq, ds, out, rows = _delta_case(T, In, Out, seed=T + In)
    aid, layer, sc = 2, 1, 1.5
    plan = wm.gemm_plan(T, Out, In, slots=7)
    emu = delta_emulate(
        torch.from_numpy(out).to(torch.bfloat16), torch.from_numpy(x), torch.from_numpy(dq[aid, layer]),
        torch.from_numpy(ds[aid, layer]), sc, torch.from_numpy(rows), plan, dequant_bf16=True,
    ).float().numpy()
    ref = out + np.asarray(
        jax_ldmm.delta_matmul_xla(jnp.asarray(x), jnp.asarray(dq), jnp.asarray(ds), jnp.int32(aid),
                                  jnp.int32(layer), jnp.asarray(rows * np.float32(sc)))
    )
    assert _gate(emu[rows], ref[rows]) > 1.0


# ------------------------------------------------------------------ launch plan


def _w4_shapes():
    """(label, M, N, K, group, stored width) of every W4A16 call
    chip_smoke.py checks and times."""
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size, stacked_out_width

    mats = [(name, In, Out) for name, In, Out, _ in chip_smoke.llama_1b_matrices()]
    mats += [("gpt-oss gate_up", 2880, 5760), ("g100", 1800, 1000)]
    mats += [(name, In, Out) for name, In, Out, _ in chip_smoke.W4_STACKED_FAR]
    ms = sorted(set(chip_smoke.W4_CHECK_M) | {64, 8192, 300})
    out = [
        (f"{name} M={M}", M, Out, In, stacked_group_size(In), stacked_out_width(Out)[0])
        for name, In, Out in mats
        for M in ms
    ]
    return out + [(f"{n} g={g} M={M}", M, Out, In, g, stacked_out_width(Out)[0])
                  for n, In, Out, g, m_list in chip_smoke.W4_MMA_GROUPS + chip_smoke.W4A16_MMA_GROUPS
                  for M in m_list]


def _delta_shapes():
    """(label, T, Out, In) of every delta call chip_smoke.py checks and
    times (eight adapter slots: seven a launch)."""
    projs = chip_smoke.llama_1b_projections() + [chip_smoke.DELTA_EDGE]
    ts = sorted(set(chip_smoke.DELTA_CHECK_T) | {64, 2048})
    return [(f"{name} T={T}", T, Out, In) for name, In, Out, _ in projs for T in ts]


def _assert_covers_once(plan, M, N, K):
    bm, bn = plan.tile
    assert (plan.m_tiles - 1) * bm < M <= plan.m_tiles * bm
    assert (plan.n_tiles - 1) * bn < N <= plan.n_tiles * bn
    blocks = [b for i in range(plan.splits) for b in range(*plan.k_range(i))]
    assert blocks == list(range(plan.k_blocks)) and plan.k_blocks == -(-K // K_BLOCK)
    assert all(plan.k_range(i)[1] > plan.k_range(i)[0] for i in range(plan.splits))  # none empty


def _kernel_workspace_bytes(plan) -> int:
    """The bytes the kernel's split-K indexing reaches (sm90_gemm.cuh:
    the counters, then chunk ((z m_tiles + y) n_tiles + x) splits + split
    of BM x BN f32)."""
    if plan.splits == 1:
        return 0
    bm, bn = plan.tile
    last_chunk = ((plan.slots - 1) * plan.m_tiles + plan.m_tiles - 1) * plan.n_tiles + plan.n_tiles - 1
    last_chunk = last_chunk * plan.splits + plan.splits - 1
    return wm.COUNTER_SLOTS * 4 + (last_chunk + 1) * bm * bn * 4


@pytest.mark.parametrize("label,M,N,K,group,width", _w4_shapes())
def test_w4a16_plan_covers_every_tile_once(label, M, N, K, group, width):
    plan = wm.w4a16_plan(M, N, K, group, width)
    if group < 16 or K % 8:  # the mma.sync kernel's remainder (chip_smoke.W4A16_MMA_GROUPS)
        assert plan is None
        return
    assert plan is not None  # GPT-OSS's groups too: split steps
    _assert_covers_once(plan, M, N, K)
    assert plan.workspace_bytes == _kernel_workspace_bytes(plan) <= wm.WORKSPACE_BYTES
    assert plan.splits == 1 or plan.slots * plan.m_tiles * plan.n_tiles <= wm.COUNTER_SLOTS
    if M == 64:  # Llama-3.2-1B decode at bs 64: one CTA an SM at least
        assert plan.ctas >= wm.SMS, plan


@pytest.mark.parametrize("label,T,N,K", _delta_shapes())
def test_delta_plan_covers_every_tile_once(label, T, N, K):
    plan = wm.gemm_plan(T, N, K, slots=7)
    _assert_covers_once(plan, T, N, K)
    assert plan.workspace_bytes == _kernel_workspace_bytes(plan) <= wm.WORKSPACE_BYTES
    assert plan.splits == 1 or plan.slots * plan.m_tiles * plan.n_tiles <= wm.COUNTER_SLOTS
    if T == 64 and label.split()[0] != "out":  # the 1B's decode shapes, per delta slot
        assert plan.ctas // plan.slots >= wm.SMS, plan


# ------------------------------------------------------------------ native


def test_a_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(native, "CSRC", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", csrc / "build")
    names = ("w4a8_matmul", "w4a16_matmul", "delta_matmul", "paged_extend_attention")
    before = {n: native._lib_path(n) for n in names}
    variant = native._lib_path("w4a16_matmul", wm.GEMM_CUT)
    assert before == {n: native._lib_path(n) for n in names}  # stable while nothing changes
    header = csrc / "sm90_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: native._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert native._lib_path("w4a16_matmul", wm.GEMM_CUT) != variant


def test_gemm_ab_times_every_shape_chip_smoke_times():
    """tools/gemm_ab.py's shapes are phase_w4_timing's (W4A8 and W4A16 at
    the same matrices, the row quantizer's) and phase_delta_timing's, with
    their calls per forward."""
    from scratchpad_tpu_torch.tools import gemm_ab

    mats = chip_smoke.llama_1b_matrices()
    assert gemm_ab.W4_MATRICES == [tuple(m) for m in mats]
    assert gemm_ab.QUANT_SHAPES == chip_smoke.QUANT_TIMED
    # the quantizer's calls a decode forward: one per W4 matrix, by input width
    calls = {}
    for _, In, _, c in mats:
        calls[In] = calls.get(In, 0) + c
    assert gemm_ab.QUANT_CALLS == calls
    assert gemm_ab.DELTA_PROJECTIONS == [tuple(p) for p in chip_smoke.llama_1b_projections()]
    timed = [(n, In, Out, M) for n, In, Out, _ in mats for M in ((64,) if n == "lm_head" else (64, 8192))]
    timed += [("gpt-oss gate_up", 2880, 5760, 64), ("g100", 1800, 1000, 64), ("gpt-oss gate_up", 2880, 5760, 8192)]
    assert [(n, In, Out, M) for n, In, Out, _, M, _ in gemm_ab.w4_shapes()] == timed
    assert {g for *_, g in gemm_ab.w4_shapes()} == {None}  # quantize_stacked's groups
    assert timed == [(n, In, Out, M) for n, In, Out, _, M in chip_smoke.w4_timed_shapes()]
    # --groups: chip_smoke.py's W4_SMALL_GROUPS, whose groups cut no step
    mats = {n: (In, Out) for n, In, Out, _ in mats}
    small = {(n, *mats[n], g) for n, g, _ in chip_smoke.W4_SMALL_GROUPS}
    assert small <= set(gemm_ab.W4_GROUP_SHAPES)
    assert all(g % 32 == 0 for *_, g in gemm_ab.W4_GROUP_SHAPES)
