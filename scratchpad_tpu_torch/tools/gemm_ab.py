#!/usr/bin/env python3
"""Time the W4A16 and delta GEMMs of two checkouts in turns, on one card.

    python3 scratchpad_tpu_torch/tools/gemm_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repository. Each runs in a
process of its own, in the order given, so that two versions of the kernels
are compared within one call on one card (A, B, B, A). A process builds the
``w4a16_matmul`` and ``delta_matmul`` libraries of its checkout, times them
through the wrappers every version takes, and prints one JSON line:
``{"root", "device", "smi", "ms": {shape: median device ms}, "cut_ms":
{...}, "per_forward": {...}}``. Where the checkout has the mainloop's
timing cut (``SPTPU_GEMM_CUT=1``: loads and conversion, no product;
``w4a16_matmul_cut``, ``delta_matmul_grouped_cut``), ``cut_ms`` holds its
times at the same shapes, so that loads and math can be told apart.

Shapes: ``chip_smoke.py``'s ``phase_w4_timing`` and ``phase_delta_timing``.
W4A16 (rows 5 and 7 of ``PERF.md``'s kernel table): Llama-3.2-1B's seven
matrices at M 64 and (but the head) 8192, GPT-OSS's 2880 -> 5760 (g 120) and
1800 -> 1000 (g 100) at M 64. The delta (row 8): the 1B's four projection
shapes at bs 64 with one and with three delta slots of three adapter slots,
and one 2048-token prefill chunk in one slot. ``per_forward`` sums calls x
ms over one 1B decode forward at bs 64 (97 W4A16 calls; 112 delta calls
with one, and with three, delta slots). Calls cycle over enough weight
copies (up to 128 MiB) to leave L2 cold, as ``chip_smoke.py`` times them.
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
# (name, In, Out, calls per 1B forward with adapters)
DELTA_PROJECTIONS = [
    ("wq|wo", 2048, 2048, 32), ("wk|wv", 2048, 512, 32), ("gate|up", 2048, 8192, 32), ("down", 8192, 2048, 16),
]
DELTA_RUNS = ((64, 1), (64, 3), (2048, 0))  # (tokens, delta slots; 0: one prefill chunk)


def w4_shapes():
    out = [(n, In, Out, c, M) for n, In, Out, c in W4_MATRICES for M in ((64,) if n == "lm_head" else (64, 8192))]
    return out + [(n, In, Out, c, 64) for n, In, Out, c in W4_ROW7]


def time_root(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from scratchpad_tpu_torch.ops import ldmm
    from scratchpad_tpu_torch.ops.quant import w4_matmul as wm
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size, stacked_out_width
    from scratchpad_tpu_torch.tools import timing
    from scratchpad_tpu_torch.utils import native

    assert Path(native.__file__).resolve().is_relative_to(Path(root).resolve()), native.__file__
    timing.resolve_device("cuda")
    has_cut = hasattr(wm, "w4a16_matmul_cut")
    targets = ["w4a16_matmul", "delta_matmul"]
    if has_cut:
        targets += [(t, wm.GEMM_CUT) for t in ("w4a16_matmul", "delta_matmul")]
    native.build(targets)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms, cut_ms = {}, {}
    for name, In, Out, _, M in w4_shapes():
        g = stacked_group_size(In)
        N = stacked_out_width(Out)[0]
        copies = max(2, min(64, -(-128 * 2**20 // (N * wm.padded_in(In) // 2))))
        q = torch.randint(0, 256, (copies, N, wm.padded_in(In) // 2), generator=gen, device="cuda",
                          dtype=torch.uint8)
        s = (torch.rand(copies, In // g, N, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
        z = (torch.randint(0, 16, (copies, In // g, N), generator=gen, device="cuda") - 8).to(torch.bfloat16)
        x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
        iters = 50 if M <= 64 else 10
        key = f"w4a16 {name} {In}->{Out} g={g} M={M}"
        ms[key] = timing.device_ms(lambda l: wm.w4a16_matmul(x, q[l], s[l], z[l], g, Out), copies, iters)
        if has_cut and wm.w4a16_plan(M, Out, In, g, N) is not None:
            cut_ms[key] = timing.device_ms(lambda l: wm.w4a16_matmul_cut(x, q[l], s[l], z[l], g, Out),
                                           copies, iters)
        del q, s, z
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
        "w4a16 1B decode forward, bs 64 (97 calls)": sum(
            c * ms[f"w4a16 {n} {In}->{Out} g={stacked_group_size(In)} M=64"] for n, In, Out, c in W4_MATRICES
        )
    }
    for n_delta in (1, 3):
        per_forward[f"delta 1B decode forward, bs 64, {n_delta} delta slots (112 calls)"] = sum(
            c * ms[f"delta {n} {In}->{Out} T=64 {n_delta} delta slots"] for n, In, Out, c in DELTA_PROJECTIONS
        )
    card = timing.card()
    return {"root": root, "device": card["device"], "smi": card["smi"], "ms": ms, "cut_ms": cut_ms,
            "per_forward": per_forward}


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_root(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    runs = []
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", root], check=True, timeout=900,
                             stdout=subprocess.PIPE, text=True)
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


if __name__ == "__main__":
    main()
