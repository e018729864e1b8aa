#!/usr/bin/env python3
"""Time the 4-bit weight GEMMs at Llama-3.1-8B's decode shapes.

    python -m scratchpad_tpu_torch.tools.w4_kernel_bench [--bs 32] [--route a16|a8] [--device cuda|cpu]

Counterpart of ``tools/bench_w4_kernel.py``: the four decode matrices of
Llama-3.1-8B (``:29-34``: qkv 4096 -> 6144, o 4096 -> 4096, gate_up 4096 ->
28672, down 14336 -> 4096), each as 4 stacked layers that the calls cycle
through, quantized by the port's ``quantize_stacked`` (random N(0, 0.02)
weights, seed 0) and packed by ``pack_w4``. ``--route a16`` (default) times
``w4a16_matmul`` on bf16 rows; ``--route a8`` ``w4a8_matmul`` on the int8
rows ``quantize_rows_int8`` made once beforehand: the port's counterpart of
the JAX tool's ``SPTPU_W4_KERNEL``. One JSON line a matrix: µs a call, GB/s
over its weight bytes (4-bit codes, bf16 scales and zeros) and their
fraction of the H100's 3.35 TB/s, not of the TPU's 819 GB/s (``:35``), then
the worst fraction. ``--blocks`` set the Pallas kernel's output tile, a TPU
tiling knob the port's kernels do not have: it is refused. ``--shape
NAME:In:Out`` replaces the matrices (the tests use small ones);
``--device cpu`` runs the plain versions, untimed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    pack_w4,
    quantize_rows_int8,
    w4a8_matmul,
    w4a16_matmul,
)
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked
from scratchpad_tpu_torch.tools import timing

# Llama-3.1-8B decode matmuls: (name, In, Out)
SHAPES = [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672), ("down", 14336, 4096)]
L = 4  # stacked layers, cycled so that the weights do not stay in the L2


def bench_shape(name, In, Out, args, dev) -> dict:
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, In, Out), dtype=np.float32) * 0.02)
    ql = quantize_stacked(w)
    del w
    g = ql.group_size
    q, s, z = (t.to(dev) for t in pack_w4(ql))
    x = torch.as_tensor(rng.standard_normal((args.bs, In)), dtype=torch.float32).to(
        device=dev, dtype=torch.bfloat16)
    if args.route == "a8":
        x8, ax, gsum = quantize_rows_int8(x, g)
        call = lambda l: w4a8_matmul(x8, ax, gsum, q[l], s[l], z[l], g, Out)
    else:
        call = lambda l: w4a16_matmul(x, q[l], s[l], z[l], g, Out)
    y = call(0)
    weight_bytes = In * Out / 2 + (In // g) * Out * 2 * 2
    r = dict(name=name, In=In, Out=Out, bs=args.bs, route=args.route, group=g,
             finite=bool(torch.isfinite(y.float()).all()), us=None, GBs=None, frac_of_3350=None)
    if dev.type == "cuda":
        ms = timing.device_ms(call, L, iters=args.iters)
        r["us"] = ms * 1e3
        r["GBs"] = weight_bytes / (ms * 1e-3) / 1e9
        r["frac_of_3350"] = r["GBs"] * 1e9 / timing.HBM_BYTES_PER_S
    return r


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--route", choices=("a16", "a8"), default="a16")
    ap.add_argument("--blocks", type=int, nargs="*", default=None)
    ap.add_argument("--shape", action="append", default=None, help="NAME:In:Out")
    timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.blocks is not None:
        raise SystemExit("--blocks sets the Pallas kernel's output tile on the TPU; the port's "
                         "W4 kernels take no tile setting")
    shapes = SHAPES
    if args.shape:
        shapes = [(n, int(i), int(o)) for n, i, o in (s.split(":") for s in args.shape)]
    dev = timing.resolve_device(args.device)
    print(json.dumps({**(timing.card() if dev.type == "cuda" else {"device": "cpu"}),
                      "route": args.route, "bs": args.bs}), flush=True)
    rows = []
    for name, In, Out in shapes:
        rows.append(bench_shape(name, In, Out, args, dev))
        print(json.dumps(rows[-1]), flush=True)
    if dev.type == "cuda":
        print(json.dumps({"worst_frac_of_3350": min(r["frac_of_3350"] for r in rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
