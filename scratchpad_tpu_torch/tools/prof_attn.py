#!/usr/bin/env python3
"""Time the decode kernel over 16 chained layers of a decode-shaped pool.

    python -m scratchpad_tpu_torch.tools.prof_attn [--device cuda|cpu] [--cases B:ctx ...]

Counterpart of ``tools/profiling/_prof_attn.py`` and ``_prof_attn2.py``:
``paged_decode_attention`` at Llama-3.2-1B's attention (Hq 32, Hkv 8, D 64,
page 16, sm_scale 0.125), layer ``l`` reading layer ``l`` of the port's
pool ``[L, pages, ps, Hkv, D]`` (zeros, 4096 pages a layer) through one
random page table, each layer's output the next layer's q. One line a case
(``_prof_attn2.py:35-39``: base 64/192, fewseq 16/768, bigctx 64/768, tiny
64/16, ctx256 64/256): ms per 16 layers, the live KV bytes they read, GB/s
and its fraction of the H100's 3.35 TB/s. ``_prof_attn.py:39-40`` also
prints a chunk-padded stream; the port's kernel reads live rows only, so
that line has no counterpart. ``--device cpu`` runs the plain version,
untimed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention
from scratchpad_tpu_torch.tools import timing

CASES = {"base": (64, 192), "fewseq": (16, 768), "bigctx": (64, 768), "tiny": (64, 16),
         "ctx256": (64, 256)}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_device_arg(ap)
    ap.add_argument("--cases", nargs="*", default=[f"{t}={b}:{c}" for t, (b, c) in CASES.items()],
                    help="TAG=B:ctx")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--pages-per-layer", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    dev = timing.resolve_device(args.device)
    L, Hkv, ps, Hq, D = args.layers, 8, 16, 32, 64
    per_layer = args.pages_per_layer
    pool = (L, per_layer, ps, Hkv, D)
    k = torch.zeros(pool, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(pool, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    print(json.dumps(timing.card() if dev.type == "cuda" else {"device": "cpu"}), flush=True)
    rows = []
    for case in args.cases:
        tag, shape = case.split("=")
        B, ctx = (int(x) for x in shape.split(":"))
        P = max(32, -(-ctx // ps))
        pt = torch.as_tensor(rng.integers(0, per_layer, (B, P)), dtype=torch.int32, device=dev)
        lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        q = torch.as_tensor(rng.standard_normal((B, Hq, D)), dtype=torch.float32).to(
            device=dev, dtype=torch.bfloat16)

        def run16(_):
            o = q
            for l in range(L):
                o = paged_decode_attention(o, k[l], v[l], pt, lens, 0.125)
            return o

        out = run16(0)
        live = B * ctx * L * 2 * Hkv * D * 2
        r = dict(tag=tag, B=B, ctx=ctx, layers=L, live_MB=live / 1e6, finite=bool(
            torch.isfinite(out.float()).all()), ms=None, GBs=None, frac_of_3350=None)
        if dev.type == "cuda":
            r["ms"] = timing.device_ms(run16, 1, iters=args.iters)
            r["GBs"] = live / (r["ms"] * 1e-3) / 1e9
            r["frac_of_3350"] = r["GBs"] * 1e9 / timing.HBM_BYTES_PER_S
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
