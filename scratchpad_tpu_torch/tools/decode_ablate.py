#!/usr/bin/env python3
"""Time the decode ablation probe and the decode kernel's stage cuts.

    python -m scratchpad_tpu_torch.tools.decode_ablate [--device cuda|cpu] [options]

Counterpart of ``tools/profiling/_ablate.py::run`` (``:91-124``). It prints
one JSON line a row of two tables (and first the card's name and power
limit):

1. ``"table": "mode"``: the probe (``ops/attention/decode_ablate.py``, the
   CUDA kernel of ``_ablate.py::make_kernel``) in each of its five modes,
   16 layers chained, each layer's ``out`` the next layer's q
   (``_ablate.py:108-113``), at the JAX probe's shape: B 64, ctx 192, Hkv 8,
   page 16, Hq 32, Dp 128, 16-page chunks, a 32-entry page table, over a
   pool of zeros (``:93``; 65,536 pages, 4.0 GiB). One deliberate
   difference: the JAX probe reads the same pages in every layer (``:96``).
   One layer's live set is 50.3 MB, about the H100's 50 MB L2, so its later
   layers would read the L2 and not the HBM; here layer ``l`` reads the table
   offset by ``l x 4096`` pages. ``ms`` is per 16 layers, ``ms_per_call`` per
   layer; ``bound_ms`` counts the live rows a decode must read, and
   ``bound_chunk_ms`` the chunk-padded rows every mode streams.
2. ``"table": "stage"``: the decode kernel (``csrc/paged_decode_attention.cu``)
   cut after each stage of its token loop (``SPTPU_DECODE_STAGE``: 1 the K
   and V loads, 2 with the dot and its ``warp_sum``, 3 with the softmax; 4
   the production kernel; 5 that kernel carrying the cuts' V sum, so that 5
   less 4 is what the cuts' checksum costs), at the shapes of PERF.md's
   decode rows: B 64, ctx 4096, page 16, Hkv 8, for Llama-3.2-1B (G 4, D
   64), 3B (G 3, D 128) and Mistral-7B (G 4, D 128), beside the full
   decode's bound.

With ``--device cpu`` it runs the plain versions at the sizes given, for the
tests, and times nothing (``ms`` null).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from scratchpad_tpu_torch.ops.attention.decode_ablate import (
    MODES,
    decode_ablate,
    decode_ablate_plain,
    num_chunks,
)
from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    DECODE_STAGE_TARGETS,
    DECODE_STAGES,
    paged_decode_attention_stage,
)
from scratchpad_tpu_torch.tools import timing
from scratchpad_tpu_torch.utils import native

STAGE_NAMES = {
    1: "K/V slices loaded and read",
    2: "+ S = q K^T (mma)",
    3: "+ cap and online softmax",
    4: "full (+ PV and the warps' merge)",
    5: "full + the cuts' V sum",
}
# (G, D) at Hkv 8: PERF.md's decode rows
STAGE_SHAPES = {"1b": (4, 64), "3b": (3, 128), "7b": (4, 128)}


# ------------------------------------------------------------ the tables


def probe_bytes(B, ctx, Hkv, Hq, Dp, ps, CP) -> tuple[float, float]:
    """(live, chunk-padded) bytes of one probe call: each row's K/V rows, q,
    out, aux, the page-table entries read and the lengths."""
    row = 2 * Hkv * Dp * 2
    chunks = max(-(-ctx // (CP * ps)), 1)
    rest = B * Hq * Dp * 2 * 2 + B * Hq * 3 * 4 + B * chunks * CP * 4 + B * 4
    return B * ctx * row + rest, B * chunks * CP * ps * row + rest


def mode_rows(args, dev) -> list[dict]:
    B, ctx, L, Hkv, ps, Hq, Dp, CP = (args.batch, args.ctx, args.layers, args.kv_heads,
                                      args.page_size, args.q_heads, args.dp, args.chunk_pages)
    per_layer = args.pages_per_layer
    rng = np.random.default_rng(0)
    kv = torch.zeros(per_layer * L, ps, 2 * Hkv, Dp, dtype=torch.bfloat16, device=dev)
    pt0 = rng.integers(0, per_layer, (B, args.table_width))
    pts = [torch.as_tensor(pt0 + l * per_layer, dtype=torch.int32, device=dev) for l in range(L)]
    lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    q = torch.as_tensor(rng.standard_normal((B, Hq, Dp)), dtype=torch.float32).to(
        device=dev, dtype=torch.bfloat16)
    live, padded = probe_bytes(B, ctx, Hkv, Hq, Dp, ps, CP)
    flops = 4.0 * B * ctx * Hq * Dp  # the real per-head QK and PV of a decode
    b_live, by = timing.bound_ms(live, flops)
    b_chunk, _ = timing.bound_ms(padded, flops)
    shape = (f"B={B} ctx={ctx} Hkv={Hkv} Hq={Hq} Dp={Dp} page={ps} CP={CP} P={args.table_width}, "
             f"pool of zeros, {L} layers chained, layer l at pages + l x {per_layer}")
    rows = []
    for mode in args.modes:
        def chain(_):
            o = q
            for l in range(L):
                o, a = decode_ablate(o, kv, pts[l], lens, mode, CP, max_seq_len=ctx)
            return o, a

        out, aux = chain(0)
        r = dict(table="mode", mode=mode, shape=shape, layers=L, out=float(out[0, 0, 0]),
                 aux=[float(x) for x in aux[0, 0]], bound_ms=b_live, bound_chunk_ms=b_chunk,
                 bound_by=by, ms=None, ms_per_call=None, plain_ms=None)
        if dev.type == "cuda":
            r["ms"] = timing.device_ms(chain, 1, iters=args.iters)
            r["ms_per_call"] = r["ms"] / L
            r["plain_ms"] = timing.device_ms(
                lambda _: decode_ablate_plain(q, kv, pts[0], lens, mode, CP, max_seq_len=ctx),
                1, iters=3, reps=3)
        rows.append(r)
    del kv
    return rows


def stage_rows(args, dev) -> list[dict]:
    B, ctx, Hkv, ps = args.stage_batch, args.stage_ctx, 8, 16
    rows = []
    for label in args.stage_models:
        G, D = STAGE_SHAPES[label]
        per_layer = B * ctx * Hkv * D * 2 * 2
        layers = max(2, min(16, -(-256 * 2**20 // per_layer))) if dev.type == "cuda" else 1
        gen = torch.Generator(device=dev).manual_seed(3000 + G + D)
        pages = B * -(-ctx // ps)
        shape = (layers, pages + 1, ps, Hkv, D)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        pt = (torch.randperm(pages, generator=gen, device=dev) + 1).to(torch.int32).view(B, -1)
        lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).to(torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        nbytes = q.numel() * 2 * 2 + B * ctx * Hkv * 2 * D * 2 + pt.numel() * 4 + B * 4
        b, by = timing.bound_ms(nbytes, 4.0 * B * ctx * Hkv * G * D)
        for stage in args.stages:
            out = paged_decode_attention_stage(stage, q, k[0], v[0], pt, lens, scale)
            r = dict(table="stage", model=label, stage=stage, what=STAGE_NAMES[stage],
                     shape=f"B={B} ctx={ctx} Hq={Hkv * G} Hkv={Hkv} D={D} page={ps}",
                     out=float(out[0, 0, 0]), bound_ms=b, bound_by=by, ms=None)
            if dev.type == "cuda":
                r["ms"] = timing.device_ms(
                    lambda l: paged_decode_attention_stage(stage, q, k[l], v[l], pt, lens, scale),
                    layers, 50)
                r["ms_over_bound"] = r["ms"] / b
            rows.append(r)
        del k, v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_device_arg(ap)
    ap.add_argument("--modes", nargs="*", default=list(MODES), choices=MODES)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=192)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--q-heads", type=int, default=32)
    ap.add_argument("--dp", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-pages", type=int, default=16)
    ap.add_argument("--table-width", type=int, default=32)
    ap.add_argument("--pages-per-layer", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20, help="16-layer chains per timed run")
    ap.add_argument("--stages", nargs="*", type=int, default=list(DECODE_STAGES),
                    choices=DECODE_STAGES)
    ap.add_argument("--stage-models", nargs="*", default=list(STAGE_SHAPES), choices=STAGE_SHAPES)
    ap.add_argument("--stage-batch", type=int, default=64)
    ap.add_argument("--stage-ctx", type=int, default=4096)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Print the card line and every row; returns the rows."""
    args = parse_args(argv)
    dev = timing.resolve_device(args.device)
    if num_chunks(torch.tensor([args.ctx]), args.chunk_pages * args.page_size).item() * \
            args.chunk_pages > args.table_width:
        raise SystemExit(f"--table-width {args.table_width} is too narrow for ctx {args.ctx}")
    print(json.dumps(timing.card() if dev.type == "cuda" else {"device": "cpu"}), flush=True)
    if dev.type == "cuda" and any(s != 4 for s in args.stages):
        native.build(DECODE_STAGE_TARGETS)
    rows = mode_rows(args, dev) if args.modes else []
    rows += stage_rows(args, dev) if args.stages else []
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
