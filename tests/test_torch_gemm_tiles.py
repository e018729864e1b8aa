"""The Hopper GEMMs' launch plan and arithmetic, on the CPU.

- A plain emulation of the arithmetic of ``csrc/w4a16_matmul.cu`` and
  ``csrc/delta_matmul.cu`` (the mainloop of ``csrc/sm90_gemm.cuh``) against
  the JAX package's functions on the same numpy-seeded inputs, at the card's
  gate |emu - ref| <= 1e-4 + 2**-8 |ref|. W4A16: the zero folded into the
  code (c - z, exact), f32 sums over 64-deep blocks folded with the group's
  scale at each group end and at each split's end, the splits' partials
  added in the plan's order, one bf16 rounding; held against
  ``w4a16_matmul_xla`` and ``_w4_kernel_q4`` in interpret mode. The delta:
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

import chip_smoke
from scratchpad_tpu.ops import ldmm as jax_ldmm
from scratchpad_tpu.ops.quant.pallas_w4 import to_4bit, w4_matmul_4bit
from scratchpad_tpu.ops.quant.w4a16 import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.ops.quant.w4a16 import slice_layer, w4a16_matmul_xla
from scratchpad_tpu_torch.ops.quant import w4_matmul as wm
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked
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


def w4a16_emulate(x, q, s, z, group_size, out_features, plan, dequant_bf16=False):
    """bf16 ``[M, out_features]`` as the kernel sums it (see the module
    docstring); ``dequant_bf16`` rounds ``(c - z) * s`` to bf16 first and
    sums the plain products instead."""
    M, In = x.shape
    xf = x.float()
    G = In // group_size
    cz = wm.unpack_w4(q, In)[:, :out_features].float() - z[:, :out_features].float().repeat_interleave(
        group_size, 0
    )  # integers in [-16, 15]
    sf = s[:, :out_features].float()
    if dequant_bf16:
        cz = (cz * sf.repeat_interleave(group_size, 0)).to(torch.bfloat16).float()
        sf = torch.ones_like(sf)
    y = None
    for split in range(plan.splits):
        b0, b1 = plan.k_range(split)
        k, end = b0 * K_BLOCK, min(b1 * K_BLOCK, In)
        part = torch.zeros(M, out_features)
        while k < end:  # one fold: to the group's end or the split's
            stop = min((k // group_size + 1) * group_size, end)
            part = part + (xf[:, k:stop] @ cz[k:stop]) * sf[min(k // group_size, G - 1)]
            k = stop
        y = part if y is None else y + part
    return y.to(torch.bfloat16)


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
    ms = sorted(set(chip_smoke.W4_CHECK_M) | {64, 8192, 300})
    return [
        (f"{name} M={M}", M, Out, In, stacked_group_size(In), stacked_out_width(Out)[0])
        for name, In, Out in mats
        for M in ms
    ]


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
    if group % 16:  # GPT-OSS's groups: the mma.sync kernel, no plan
        assert plan is None
        return
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
    names = ("w4a16_matmul", "delta_matmul", "paged_extend_attention")
    before = {n: native._lib_path(n) for n in names}
    variant = native._lib_path("w4a16_matmul", wm.GEMM_CUT)
    assert before == {n: native._lib_path(n) for n in names}  # stable while nothing changes
    header = csrc / "sm90_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: native._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert native._lib_path("w4a16_matmul", wm.GEMM_CUT) != variant


def test_gemm_ab_times_every_shape_chip_smoke_times():
    """tools/gemm_ab.py's shapes are phase_w4_timing's and
    phase_delta_timing's, with their calls per forward."""
    from scratchpad_tpu_torch.tools import gemm_ab

    mats = chip_smoke.llama_1b_matrices()
    assert gemm_ab.W4_MATRICES == [tuple(m) for m in mats]
    assert gemm_ab.DELTA_PROJECTIONS == [tuple(p) for p in chip_smoke.llama_1b_projections()]
    timed = [(n, In, Out, M) for n, In, Out, _ in mats for M in ((64,) if n == "lm_head" else (64, 8192))]
    timed += [("gpt-oss gate_up", 2880, 5760, 64), ("g100", 1800, 1000, 64)]
    assert [(n, In, Out, M) for n, In, Out, _, M in gemm_ab.w4_shapes()] == timed
