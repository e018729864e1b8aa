#!/usr/bin/env python3
"""Time the extend kernel beside two cuts of it, at the main path's shapes.

    python -m scratchpad_tpu_torch.tools.extend_stages [--device cuda|cpu] [--shapes TAG ...]

``csrc/paged_extend_attention.cu`` built three ways (variant libraries,
``-DSPTPU_EXTEND_CUT``): ``loads`` (1) stops each KV tile once it has landed
in shared memory (8-bit pages: once the producer has converted it), so it
times the producer warpgroup alone; ``compute`` (4) copies only the first
four tiles (8-bit pages: no codes) and computes every tile on whatever the
ring holds, so it times the compute warpgroups (and, on 8-bit pages, the
producer's conversion); ``kernel`` (0)
is the production kernel. When ``kernel`` is near ``loads + compute`` the two
do not overlap; near the larger of them, they do. One JSON line a shape
with ms of each, the bound (bytes at 3.35 TB/s or operations at 989
TFLOP/s, the larger) and the card. The cuts' outputs are not attention.
``--device cpu`` runs the plain version at each shape's tiny stand-in,
untimed.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from scratchpad_tpu_torch.ops.attention import quantize_rows
from scratchpad_tpu_torch.ops.attention import ragged_backend as rb
from scratchpad_tpu_torch.ops.attention.gqa_decode import CODE_TYPES
from scratchpad_tpu_torch.tools import timing
from scratchpad_tpu_torch.utils import native

CUTS = {"loads": 1, "compute": 4, "kernel": 0}
# tag: (B, q_len, kv_len, G, D, pages)
SHAPES = {
    "1b-long": (1, 2048, 8192, 4, 64, "bf16"),
    "7b-long": (1, 2048, 8192, 4, 128, "bf16"),
    "3b-int8-long": (1, 2048, 8192, 3, 128, "int8"),
    "1b-64x128": (64, 128, 128, 4, 64, "bf16"),
}
HKV, PAGE, LAYERS = 8, 16, 4


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_device_arg(ap)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    return ap.parse_args(argv)


def make_case(B, q_len, kv_len, G, D, pages, dev, layers):
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pages = B * kv_len // PAGE
    pool = (layers, n_pages + 1, PAGE, HKV, D)
    k = torch.randn(pool, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(pool, generator=gen, device=dev).to(torch.bfloat16)
    ks = vs = None
    if pages != "bf16":
        code = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[pages]
        k, ks = quantize_rows(k, code)
        v, vs = quantize_rows(v * 0.05, code)
    pt = (torch.randperm(n_pages, generator=gen, device=dev) + 1).to(torch.int32).view(B, -1)
    q = torch.randn(B * q_len, HKV * G, D, generator=gen, device=dev).to(torch.bfloat16)
    kv_lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
    cu = torch.arange(B + 1, dtype=torch.int32, device=dev) * q_len
    return q, k, v, ks, vs, pt, kv_lens, cu


def launcher(cut: int, q, k, v, ks, vs, pt, kv_lens, cu):
    """fn(layer) launching the cut's library on the case."""
    lib = native.load("paged_extend_attention", rb._SIGNATURES, {"SPTPU_EXTEND_CUT": cut})
    T, Hq, D = q.shape
    tile_seq, tile_cum = rb.tile_map(cu, T, lib.paged_extend_tokens_per_tile(Hq // HKV, D))
    out = torch.empty_like(q)
    stream = native.stream_handle(q.device)
    scale = 1.0 / math.sqrt(D)

    def fn(l):
        tail = (pt.data_ptr(), kv_lens.data_ptr(), cu.data_ptr(), tile_seq.data_ptr(),
                tile_cum.data_ptr(), out.data_ptr(), tile_seq.shape[0], kv_lens.shape[0], T, Hq,
                HKV, D, pt.shape[1], PAGE)
        head = (q.data_ptr(), k[l].data_ptr(), v[l].data_ptr())
        if ks is None:
            rc = lib.paged_extend_attention(*head, *tail, scale, 0.0, 0, 0, None, stream)
        else:
            rc = lib.paged_extend_attention_quant(
                *head, ks[l].data_ptr(), vs[l].data_ptr(), *tail, CODE_TYPES[k.dtype], scale,
                0.0, 0, 0, None, stream,
            )
        if rc != 0:
            raise RuntimeError(f"extend cut {cut}: cudaError {rc}")

    return fn


def bound(B, q_len, kv_len, G, D, pages) -> tuple[float, str]:
    elem = 2 if pages == "bf16" else 1
    attended = B * sum(min(p + 1, kv_len) for p in range(kv_len - q_len, kv_len))
    kv_bytes = B * kv_len * HKV * 2 * (D * elem + (0 if pages == "bf16" else 2))
    nbytes = B * q_len * HKV * G * D * 2 * 2 + kv_bytes
    return timing.bound_ms(nbytes, 4.0 * attended * HKV * G * D)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    dev = timing.resolve_device(args.device)
    print(json.dumps(timing.card() if dev.type == "cuda" else {"device": "cpu"}), flush=True)
    if dev.type == "cuda":
        native.build([("paged_extend_attention", {"SPTPU_EXTEND_CUT": c}) for c in CUTS.values()])
    rows = []
    for tag in args.shapes:
        B, q_len, kv_len, G, D, pages = SHAPES[tag]
        if dev.type == "cpu":  # the plain version at a tiny stand-in, untimed
            B, q_len, kv_len = min(B, 2), 16, 48
        case = make_case(B, q_len, kv_len, G, D, pages, dev, LAYERS if dev.type == "cuda" else 1)
        row = {"shape": tag, "B": B, "q_len": q_len, "kv_len": kv_len, "G": G, "D": D,
               "pages": pages}
        if dev.type == "cpu":
            q, k, v, ks, vs, pt, kv_lens, cu = case
            out = rb.paged_extend_attention_plain(
                q, k[0], v[0], pt, kv_lens, cu, 1.0 / math.sqrt(D),
                None if ks is None else ks[0], None if vs is None else vs[0],
            )
            row["finite"] = bool(torch.isfinite(out).all())
        else:
            for name, cut in CUTS.items():
                row[f"{name}_ms"] = timing.device_ms(launcher(cut, *case), LAYERS, 10)
            row["bound_ms"], row["bound_by"] = bound(B, q_len, kv_len, G, D, pages)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del case
    return rows


if __name__ == "__main__":
    main()
