#!/usr/bin/env python3
"""Time the W4 and delta GEMMs and the row quantizer of two checkouts in
turns, on one card.

    python3 scratchpad_tpu_torch/tools/gemm_ab.py [--w4 | --groups] ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repository. Each runs in a
process of its own, in the order given, so that two versions of the kernels
are compared within one call on one card (A, B, B, A). A process builds the
``w4a8_matmul``, ``w4a16_matmul`` and ``delta_matmul`` libraries of its
checkout, times them through the wrappers every version takes, and prints
one JSON line:
``{"root", "device", "smi", "ms": {shape: median device ms}, "cut_ms":
{...}, "per_forward": {...}}``. Where the checkout has the kernels' timing
cut (``SPTPU_GEMM_CUT=1``: loads and conversion, no product;
``w4a16_matmul_cut``, ``delta_matmul_grouped_cut``, ``w4a8_matmul_cut``),
``cut_ms`` holds its times at the same shapes, so that loads and math can
be told apart.

Shapes: ``chip_smoke.py``'s ``phase_w4_timing`` and ``phase_delta_timing``.
W4A8 and W4A16 (rows 4 to 7 of ``PERF.md``'s kernel table): Llama-3.2-1B's
seven matrices at M 64 and (but the head) 8192, GPT-OSS's 2880 -> 5760 (g
120) at M 64 and 8192 and 1800 -> 1000 (g 100) at M 64 (``W4_ROW7``, the
groups that cut a tensor-core step), W4A8 on int8 rows the quantizer made
once beforehand. Each checkout gets random zero points 0..15 in its own
layout (``zero_offset``: an older ``pack_w4`` stored z - 8). The row quantizer at In 2048 and 8192, M 64 and 8192 (g
128). The delta (row 8): the 1B's four projection shapes at bs 64 with one
and with three delta slots of three adapter slots, and one 2048-token
prefill chunk in one slot. ``per_forward`` sums calls x ms over one 1B
decode forward at bs 64 (97 W4A8, W4A16 and quantizer calls, and the W4A8
linear's two together; 112 delta calls with one, and with three, delta
slots). Calls cycle over enough weight (or activation) copies (up to 128
MiB) to leave L2 cold, as ``chip_smoke.py`` times them.

Where the checkout has ``w4a8_matmul_with_plan``, ``plan_ms`` also holds W4A8's decode
kernel at bs 64 under other plans than its own (``PLAN_SWEEP``: token
tiles of 64 and 32, K splits from 1 to 32) at the 1B's and Llama-3.2-3B's
matrices, and at GPT-OSS's groups where the checkout's plan takes them, so
that the plan's rule can be checked against its neighbours. ``--w4`` times
the W4 GEMMs alone (no quantizer, no delta) and sweeps GPT-OSS's plans
only. ``--groups`` times the W4 GEMMs alone at groups of 64 and 32
(``W4_GROUP_SHAPES``, M 64 and 8192), which fold inside a k block but cut
no tensor-core step, with no cut and no sweep: a checkout that runs them
on the split-step instantiations against one that does not.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (name, In, Out, calls per 1B forward) and the Ms each is timed at
W4_MATRICES = [
    ("wq", 2048, 2048, 16), ("wk", 2048, 512, 16), ("wv", 2048, 512, 16), ("wo", 2048, 2048, 16),
    ("gate_up", 2048, 16384, 16), ("down", 8192, 2048, 16), ("lm_head", 2048, 128256, 1),
]
W4_ROW7 = [("gpt-oss gate_up", 2880, 5760, 0), ("g100", 1800, 1000, 0)]
W4_ROW7_PREFILL = [("gpt-oss gate_up", 2880, 5760, 0)]  # also at M 8192
# groups of 64 and 32 at the 1B's matrices (chip_smoke.py's W4_SMALL_GROUPS,
# and gate_up): (name, In, Out, group), each at M 64 and 8192
W4_GROUP_SHAPES = [("wq", 2048, 2048, 64), ("wk", 2048, 512, 32), ("down", 8192, 2048, 32),
                   ("gate_up", 2048, 16384, 32)]
# (name, In, Out, calls per 1B forward with adapters)
DELTA_PROJECTIONS = [
    ("wq|wo", 2048, 2048, 32), ("wk|wv", 2048, 512, 32), ("gate|up", 2048, 8192, 32), ("down", 8192, 2048, 16),
]
DELTA_RUNS = ((64, 1), (64, 3), (2048, 0))  # (tokens, delta slots; 0: one prefill chunk)
QUANT_SHAPES = [(In, M) for In in (2048, 8192) for M in (64, 8192)]
# W4A8's decode plans tried at bs 64: the 1B's matrices (but the head) and
# Llama-3.2-3B's, each under token tiles of 64 and 32 and these K splits
PLAN_SHAPES = [(n, In, Out, 128) for n, In, Out, _ in W4_MATRICES[:6]] + [
    ("3b wq", 3072, 3072, 128), ("3b wk", 3072, 1024, 128), ("3b gate_up", 3072, 16384, 128),
    ("3b down", 8192, 3072, 128),
]
# GPT-OSS's groups, which cut a 32-deep step (name, In, Out, group)
PLAN_SHAPES_ROW6 = [("gpt-oss gate_up", 2880, 5760, 120), ("g100", 1800, 1000, 100)]
PLAN_SWEEP = (1, 2, 4, 8, 16, 32)
# the 1B's quantizer calls a decode forward: 5 of its 6 per-layer inputs and
# the head's are 2048 wide, the down projection's 8192
QUANT_CALLS = {2048: 5 * 16 + 1, 8192: 16}


def w4_shapes(groups: bool = False):
    """(name, In, Out, calls per 1B forward, M, group) of the W4 times;
    group None: ``quantize_stacked``'s."""
    if groups:
        return [(n, In, Out, 0, M, g) for n, In, Out, g in W4_GROUP_SHAPES for M in (64, 8192)]
    out = [(n, In, Out, c, M) for n, In, Out, c in W4_MATRICES for M in ((64,) if n == "lm_head" else (64, 8192))]
    out += [(n, In, Out, c, 64) for n, In, Out, c in W4_ROW7]
    out += [(n, In, Out, c, 8192) for n, In, Out, c in W4_ROW7_PREFILL]
    return [(*shape, None) for shape in out]


def zero_offset(wm, QuantizedLinear) -> int:
    """8 where a checkout's ``pack_w4`` stores the zero point less 8, else
    0: what a random zero point in 0..15 is stored as, less it."""
    import torch

    ql = QuantizedLinear(torch.zeros(16, 1, dtype=torch.uint8), torch.ones(1, 1, dtype=torch.bfloat16),
                         torch.full((1, 1), 8.0, dtype=torch.bfloat16), 32)
    return 8 - int(wm.pack_w4(ql)[2].float().item())


def time_root(root: str, w4_only: bool = False, groups: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    from scratchpad_tpu_torch.ops import ldmm
    from scratchpad_tpu_torch.ops.quant import w4_matmul as wm
    from scratchpad_tpu_torch.ops.quant.w4a16 import QuantizedLinear, stacked_group_size, stacked_out_width
    from scratchpad_tpu_torch.tools import timing
    from scratchpad_tpu_torch.utils import native

    assert Path(native.__file__).resolve().is_relative_to(Path(root).resolve()), native.__file__
    timing.resolve_device("cuda")
    has_cut = hasattr(wm, "w4a16_matmul_cut") and not groups
    has_cut8 = hasattr(wm, "w4a8_matmul_cut") and not groups
    targets = ["w4a8_matmul", "w4a16_matmul", "delta_matmul"]
    if has_cut:
        targets += [(t, wm.GEMM_CUT) for t in ("w4a16_matmul", "delta_matmul")]
    if has_cut8:
        targets.append(("w4a8_matmul", wm.GEMM_CUT))
    native.build(targets)
    gen = torch.Generator(device="cuda").manual_seed(0)
    off = zero_offset(wm, QuantizedLinear)
    ms, cut_ms = {}, {}
    for name, In, Out, _, M, group in w4_shapes(groups):
        g = group or stacked_group_size(In)
        N = stacked_out_width(Out)[0]
        copies = max(2, min(64, -(-128 * 2**20 // (N * wm.padded_in(In) // 2))))
        q = torch.randint(0, 256, (copies, N, wm.padded_in(In) // 2), generator=gen, device="cuda",
                          dtype=torch.uint8)
        s = (torch.rand(copies, In // g, N, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
        z = (torch.randint(0, 16, (copies, In // g, N), generator=gen, device="cuda") - off).to(torch.bfloat16)
        x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
        x8, ax, gsum = wm.quantize_rows_int8(x, g)
        iters = 50 if M <= 64 else 10
        key8 = f"w4a8 {name} {In}->{Out} g={g} M={M}"
        ms[key8] = timing.device_ms(lambda l: wm.w4a8_matmul(x8, ax, gsum, q[l], s[l], z[l], g, Out), copies, iters)
        if has_cut8 and wm.w4a8_plan(M, Out, In, g, N) is not None:
            cut_ms[key8] = timing.device_ms(lambda l: wm.w4a8_matmul_cut(x8, ax, gsum, q[l], s[l], z[l], g, Out),
                                            copies, iters)
        key = f"w4a16 {name} {In}->{Out} g={g} M={M}"
        ms[key] = timing.device_ms(lambda l: wm.w4a16_matmul(x, q[l], s[l], z[l], g, Out), copies, iters)
        if has_cut and wm.w4a16_plan(M, Out, In, g, N) is not None:
            cut_ms[key] = timing.device_ms(lambda l: wm.w4a16_matmul_cut(x, q[l], s[l], z[l], g, Out),
                                           copies, iters)
        del q, s, z
        torch.cuda.empty_cache()
    plan_ms = {}
    if hasattr(wm, "w4a8_matmul_with_plan") and not groups:
        for name, In, Out, g in ([] if w4_only else PLAN_SHAPES) + PLAN_SHAPES_ROW6:
            N = stacked_out_width(Out)[0]
            own = wm.w4a8_plan(64, Out, In, g, N)
            if own is None:  # the checkout leaves this group to its mma.sync kernel
                continue
            Kp = wm.padded_in(In)
            copies = max(2, min(64, -(-128 * 2**20 // (N * Kp // 2))))
            q = torch.randint(0, 256, (copies, N, Kp // 2), generator=gen, device="cuda", dtype=torch.uint8)
            s = (torch.rand(copies, In // g, N, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
            z = (torch.randint(0, 16, (copies, In // g, N), generator=gen, device="cuda") - off).to(torch.bfloat16)
            x8, ax, gsum = wm.quantize_rows_int8(torch.randn(64, In, generator=gen, device="cuda").to(torch.bfloat16), g)
            for rows in (64, 32):
                for splits in sorted({sp for sp in PLAN_SWEEP if sp <= own.k_blocks} | {own.splits}):
                    plan = wm.w4a8_decode_plan(64, Out, In, rows, splits)
                    if plan.splits != splits:  # the workspace holds fewer
                        continue
                    key = f"w4a8 {name} {In}->{Out} g={g} M=64 rows={rows} splits={splits} ({plan.ctas} CTAs)"
                    key += " (the plan)" if plan == own else ""
                    plan_ms[key] = timing.device_ms(
                        lambda l: wm.w4a8_matmul_with_plan(x8, ax, gsum, q[l], s[l], z[l], g, Out, plan), copies, 50
                    )
            del q, s, z
            torch.cuda.empty_cache()
    if w4_only or groups:
        card = timing.card()
        return {"root": root, "device": card["device"], "smi": card["smi"], "ms": ms, "cut_ms": cut_ms,
                "per_forward": {}, "plan_ms": plan_ms}
    for In, M in QUANT_SHAPES:
        copies = max(2, min(64, -(-128 * 2**20 // (M * In * 2))))
        xs = torch.randn(copies, M, In, generator=gen, device="cuda").to(torch.bfloat16)
        ms[f"quantize_rows_int8 In={In} M={M} g=128"] = timing.device_ms(
            lambda l: wm.quantize_rows_int8(xs[l], 128), copies, 50
        )
        del xs
        torch.cuda.empty_cache()
    for name, In, Out, _ in DELTA_PROJECTIONS:
        for T, n_delta in DELTA_RUNS:
            layers = max(2, min(64, -(-128 * 2**20 // (In * Out))))
            dq = torch.randint(-127, 128, (4, layers, In, Out), generator=gen, device="cuda", dtype=torch.int8)
            ds = torch.rand(4, layers, Out, generator=gen, device="cuda") * 2e-3
            scaling = torch.linspace(0.5, 2.0, 4, device="cuda")
            if n_delta:  # rows round-robin over slots 0..3; the last n_delta slots hold a delta
                has = torch.tensor([0] + [int(j >= 4 - n_delta) for j in range(1, 4)], dtype=torch.int32,
                                   device="cuda")
                slots = (torch.arange(T, device="cuda") % 4).to(torch.int32)
            else:
                has = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device="cuda")
                slots = torch.ones(T, dtype=torch.int32, device="cuda")
            act = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
            x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
            iters = 50 if T <= 64 else 10
            key = f"delta {name} {In}->{Out} T={T} " + (f"{n_delta} delta slots" if n_delta else "prefill chunk")
            ms[key] = timing.device_ms(
                lambda l: ldmm.delta_matmul_grouped(out, x, dq, ds, l, act, has, scaling, slots), layers, iters
            )
            if has_cut:
                cut_ms[key] = timing.device_ms(
                    lambda l: ldmm.delta_matmul_grouped_cut(out, x, dq, ds, l, act, has, scaling, slots),
                    layers, iters,
                )
            del dq, ds
            torch.cuda.empty_cache()
    per_forward = {
        f"{k} 1B decode forward, bs 64 (97 calls)": sum(
            c * ms[f"{k} {n} {In}->{Out} g={stacked_group_size(In)} M=64"] for n, In, Out, c in W4_MATRICES
        )
        for k in ("w4a8", "w4a16")
    }
    per_forward["quantize_rows_int8 1B decode forward, bs 64 (97 calls)"] = sum(
        c * ms[f"quantize_rows_int8 In={In} M=64 g=128"] for In, c in QUANT_CALLS.items()
    )
    per_forward["W4A8 linear (quantizer and GEMM) 1B decode forward, bs 64"] = (
        per_forward["w4a8 1B decode forward, bs 64 (97 calls)"]
        + per_forward["quantize_rows_int8 1B decode forward, bs 64 (97 calls)"]
    )
    for n_delta in (1, 3):
        per_forward[f"delta 1B decode forward, bs 64, {n_delta} delta slots (112 calls)"] = sum(
            c * ms[f"delta {n} {In}->{Out} T=64 {n_delta} delta slots"] for n, In, Out, c in DELTA_PROJECTIONS
        )
    card = timing.card()
    return {"root": root, "device": card["device"], "smi": card["smi"], "ms": ms, "cut_ms": cut_ms,
            "per_forward": per_forward, "plan_ms": plan_ms}


def main() -> None:
    args = sys.argv[1:]
    modes = [a for a in args if a in ("--w4", "--groups")]
    args = [a for a in args if a not in modes]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(time_root(args[1], "--w4" in modes, "--groups" in modes)), flush=True)
        return
    if not args:
        sys.exit(__doc__)
    runs = []
    for root in args:
        res = subprocess.run([sys.executable, __file__, "--one", root] + modes, check=True,
                             timeout=900, stdout=subprocess.PIPE, text=True)
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    # one line a shape: each run's ms in order, then the cut where a run has it
    for key in runs[0]["ms"]:
        times = "; ".join(f"{r['ms'][key]:.4f}" for r in runs)
        cuts = "; ".join(f"{r['cut_ms'][key]:.4f}" for r in runs if key in r["cut_ms"])
        print(f"[ab] {key}: {times}" + (f" (cut {cuts})" if cuts else ""), flush=True)
    for key in runs[0]["per_forward"]:
        print(f"[ab] {key}: " + "; ".join(f"{r['per_forward'][key]:.4f}" for r in runs), flush=True)
    for r in runs:  # each distinct checkout's plan sweep once
        if r["plan_ms"] and r["root"] not in {p["root"] for p in runs[: runs.index(r)]}:
            for key, t in r["plan_ms"].items():
                print(f"[plan] {r['root']} {key}: {t:.4f}", flush=True)


if __name__ == "__main__":
    main()
