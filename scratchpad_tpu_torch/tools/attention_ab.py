#!/usr/bin/env python3
"""Time the attention kernels of two checkouts in turns, on one card.

    python3 scratchpad_tpu_torch/tools/attention_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repository. Each runs in a
process of its own, in the order given, so that two versions of the kernels
are compared within one call on one card (A, B, B, A). A process builds the
decode and extend kernels of its checkout, times them with no cap and no
window at the shapes below and prints one JSON line: ``{"root": ...,
"device": ..., "ms": {shape: median device ms}}``. The calls take the
positional arguments every version of the wrappers takes.

Shapes (page 16, Hkv 8): the decode at every shape of ``chip_smoke.py``'s
decode timings (``DECODE_SHAPES``: bs 64 at 256, 4096 and 8192 tokens and
B 1 at 4096 and 8192, at Llama-3.2-1B's (G 4, D 64), 3B's (G 3, D 128) and
Mistral-7B's (G 4, D 128) shapes, the 7B's window of 4096 through both
wrappers, int8 and fp8 pages); the extend at every shape of
``chip_smoke.py``'s extend timings: 64 x (128, 128) and one 2048-token chunk
on 8192 tokens at the 1B's shape; 64 x (128, 128) at the 3B's over bf16,
int8 and fp8 pages and its 2048-token chunk on 8192 over int8 pages; and
Mistral-7B's (G 4, D 128) 2048-token chunk on 4096, 5120 and 8192 tokens and
on 8192 with a window of 4096. 8-bit pages go through the KV quantizer
(``quantize_rows``), V scaled by 0.05 as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's DECODE_TIMED: (B, ctx, D, G, pages, window, wrapper)
DECODE_SHAPES = [
    (64, 256, 64, 4, "bf16", None, "auto"), (64, 4096, 64, 4, "bf16", None, "auto"),
    (64, 4096, 128, 3, "bf16", None, "auto"), (64, 4096, 128, 4, "bf16", None, "auto"),
    (64, 8192, 128, 4, "bf16", None, "auto"), (64, 8192, 128, 4, "bf16", 4096, "auto"),
    (1, 4096, 64, 4, "bf16", None, "auto"), (1, 4096, 128, 3, "bf16", None, "auto"),
    (1, 8192, 128, 4, "bf16", None, "auto"),
    (64, 8192, 128, 4, "bf16", 4096, "pallas"),
    (64, 4096, 128, 3, "int8", None, "auto"), (64, 4096, 128, 3, "fp8", None, "auto"),
    (64, 4096, 64, 4, "int8", None, "auto"), (64, 4096, 64, 4, "fp8", None, "auto"),
    (64, 256, 128, 3, "int8", None, "auto"),
]


def decode_label(B, ctx, D, G, kind, window, wrapper) -> str:
    return (f"decode {'' if kind == 'bf16' else kind + ' '}B={B} ctx={ctx} G={G} D={D}"
            + (f" W={window}" if window else "") + (" (pallas)" if wrapper == "pallas" else ""))


# decode: ("decode", B, ctx, D, G, pages, window, wrapper); extend: (kind, B,
# q_len, kv_len, G, D, pages, window)
SHAPES = {
    **{decode_label(*d): ("decode", *d) for d in DECODE_SHAPES},
    "extend 64 x (128 on 128) G=4 D=64": ("extend", 64, 128, 128, 4, 64, "bf16", None),
    "extend 1 x (2048 on 8192) G=4 D=64": ("extend", 1, 2048, 8192, 4, 64, "bf16", None),
    "extend 64 x (128 on 128) G=3 D=128": ("extend", 64, 128, 128, 3, 128, "bf16", None),
    "extend 1 x (2048 on 4096) G=4 D=128": ("extend", 1, 2048, 4096, 4, 128, "bf16", None),
    "extend 1 x (2048 on 5120) G=4 D=128": ("extend", 1, 2048, 5120, 4, 128, "bf16", None),
    "extend 1 x (2048 on 8192) G=4 D=128": ("extend", 1, 2048, 8192, 4, 128, "bf16", None),
    "extend 1 x (2048 on 8192) G=4 D=128 W=4096": ("extend", 1, 2048, 8192, 4, 128, "bf16", 4096),
    "extend int8 64 x (128 on 128) G=3 D=128": ("extend", 64, 128, 128, 3, 128, "int8", None),
    "extend int8 1 x (2048 on 8192) G=3 D=128": ("extend", 1, 2048, 8192, 3, 128, "int8", None),
    "extend fp8 64 x (128 on 128) G=3 D=128": ("extend", 64, 128, 128, 3, 128, "fp8", None),
}


def device_ms(fn, n: int, iters: int, reps: int = 5) -> float:
    """Median device ms per call over ``reps`` runs of ``iters`` calls that
    cycle over ``n`` buffers, queued behind a sleep kernel (as
    ``chip_smoke.py`` times its kernels)."""
    import torch

    for i in range(3):
        fn(i % n)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for i in range(iters):
            fn(i % n)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def time_root(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
    from scratchpad_tpu_torch.memory.kv_cache import KVCache
    from scratchpad_tpu_torch.ops.attention import (
        decode_attention_pallas,
        paged_decode_attention,
        paged_decode_attention_quant,
        paged_extend_attention,
        paged_extend_attention_quant,
        quantize_rows,
    )
    from scratchpad_tpu_torch.utils import native

    assert Path(native.__file__).resolve().is_relative_to(Path(root).resolve()), native.__file__
    native.build(("paged_decode_attention", "paged_extend_attention"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    Hkv, ps, layers = 8, 16, 4
    codes = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    out = {}
    for name, shape in SHAPES.items():
        if shape[0] == "decode":
            _, B, ctx, D, G, kind, window, wrapper = shape
        else:
            _, B, q_len, ctx, G, D, kind, window = shape
        pages = B * ctx // ps
        # the decode cycles over at least 256 MB of pages (as chip_smoke.py's
        # time_decode), so that no layer finds its pages in the 50 MB L2
        n = layers if shape[0] != "decode" else max(layers, min(16, -(-(256 << 20) // (B * ctx * Hkv * D * 4))))
        pool = (n, pages + 1, ps, Hkv, D)
        k = torch.randn(pool, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(pool, generator=gen, device="cuda").to(torch.bfloat16)
        pt = (torch.randperm(pages, generator=gen, device="cuda") + 1).to(torch.int32).view(B, -1)
        scale = 1.0 / math.sqrt(D)
        if shape[0] == "decode":
            q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
            if wrapper == "pallas":
                rows = torch.arange(B, device="cuda")
                meta = ForwardMeta(
                    mode=ForwardMode.DECODE, tokens=rows, positions=rows, out_cache_loc=rows,
                    req_indices=rows, page_table=pt, seq_lens=lens, extend_lens=torch.ones_like(lens),
                    last_token_idx=rows,
                )
                pool = KVCache(k, v)
                fn = lambda l: decode_attention_pallas(q, pool, l, meta, sm_scale=scale, sliding_window=window)
            elif kind == "bf16":
                fn = lambda l: paged_decode_attention(q, k[l], v[l], pt, lens, scale, None, window)
            else:
                k, ks = quantize_rows(k, codes[kind])
                v, vs = quantize_rows(v * 0.05, codes[kind])
                fn = lambda l: paged_decode_attention_quant(
                    q, k[l], v[l], ks[l], vs[l], pt, lens, scale, None, window
                )
            iters = 50
        else:
            q = torch.randn(B * q_len, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            kv_lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
            cu = torch.arange(B + 1, dtype=torch.int32, device="cuda") * q_len
            if kind == "bf16":
                fn = lambda l: paged_extend_attention(
                    q, k[l], v[l], pt, kv_lens, cu, scale, None, window
                )
            else:
                k, ks = quantize_rows(k, codes[kind])
                v, vs = quantize_rows(v * 0.05, codes[kind])
                fn = lambda l: paged_extend_attention_quant(
                    q, k[l], v[l], ks[l], vs[l], pt, kv_lens, cu, scale, None, window
                )
            iters = 10
        out[name] = device_ms(fn, n, iters)
        del k, v
        torch.cuda.empty_cache()
    return {"root": root, "device": torch.cuda.get_device_name(0), "ms": out}


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_root(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True, timeout=600)


if __name__ == "__main__":
    main()
