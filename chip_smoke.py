#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scratchpad_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device is a failure.
2. build: compiles every CUDA kernel of the port from ``scratchpad_tpu_torch/
   csrc`` with ``nvcc`` for sm_90a, one ``nvcc`` per source, in parallel,
   and with them the decode kernel's four stage variants (``-DSPTPU_DECODE_
   STAGE=1, 2, 3, 5``, variant libraries of the same source). ``[sass]``
   lines count the tensor-core (``HGMMA``, ``HMMA``) and asynchronous-copy
   (``LDGSTS``, ``UTMALDG``) instructions of the extend, W4A16 and delta
   libraries (``SASS_LIBRARIES``) from ``cuobjdump --dump-sass``; a library
   without a tensor-core instruction fails, and so does a W4A16 or delta
   library without ``HGMMA`` or without an asynchronous copy.
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   same inputs (the plain version computes and returns f32). Attention, on
   bf16 pages and on int8 and fp8 (e4m3) pages with per-(token, head) bf16
   scales: decode shapes of short (256) and long (4096) contexts, batch 1
   and 64, head_dim 64 and 128, 4 and 3 query heads per kv head (Llama-3.2-
   1B's and 3B's), with ``seq_len == 0`` rows; extend shapes with mixed
   chunk lengths, cached prefixes and padded tokens. The KV quantizer on the
   card must match itself on the CPU bit for bit. The
   4-bit GEMMs: Llama-3.2-1B's seven matrices at M of 1, 64, 65, 129, 200
   and 2048 (``W4_CHECK_M``), a group of 120 (GPT-OSS's 2880 -> 5760) and
   of 100 with a padded Out, each GEMM on the same int8 (W4A8) or bf16
   (W4A16) rows as its plain version; the row quantizer must match its
   plain version bit for bit. The grouped int8 delta kernel of the toppings
   path: Llama-3.2-1B's projection shapes (2048 -> 2048, 512, 8192; 8192 ->
   2048) and 2048 -> 1000 at 1, 7, 64, 65, 129 and 2048 tokens, over five
   slot layouts (one slot; all eight mixed; a slot with no tokens; a
   LoRA-only slot; no adapter at all). Where the W4A16 or delta launch plan
   splits K across CTAs, a second call must give the same bits. The soft cap and the
   static sliding window at Mistral-7B's shape (G 4, head_dim 128): decode
   at B 1 and 64, contexts 256, 4096 and 8192, for each (cap, W) of
   ``CAPS_WINDOWS`` over bf16 pages and ``CAPS_WINDOWS_8BIT`` over int8 and
   fp8 pages; extend with a 2048-token chunk on 6,000 cached tokens and
   mixed chunks whose window edge falls inside a query tile and a page; and
   ``decode_attention_pallas`` (the port of ``pallas_decode._decode_kernel``)
   at its JAX test's shape with cap 30 and W 8, and at Mistral-7B's. Tolerance:
   |kernel - plain| <= ATOL + RTOL * |plain| elementwise (see below);
   padding and zero rows must come out as exact zeros, and rows outside a
   delta slot bit-equal to the delta kernel's input. The decode ablation
   probe (``decode_ablate``, the port of ``_ablate.py::make_kernel``) in all
   five modes at the JAX probe's shape (B 64, Hkv 8, page 16, 16-page
   chunks) at ctx 192 and 1000 (chunk and page edges inside the rows), with
   rows of 0 and 1 tokens, at G 3 and 4 and Dp 64 and 128: its ``out``
   within one bf16 ulp of the plain version's, its ``aux`` with ``m``
   exact and ``l`` and the checksum within ATOL + 2**-12 * |plain|
   (``aux_tolerance``: aux is f32, never rounded to bf16). The decode
   kernel's stage cuts (1, 2, 3 and 5) against their plain functions
   (``gqa_decode.py::paged_decode_attention_stage_plain``) at each shape
   the stage table times (Llama-3.2-1B's, 3B's and Mistral-7B's decode at
   B 64, ctx 4096), within ATOL + RTOL * |plain|.
4. engines: ``Engine.generate`` at full width and depth with random
   weights: Llama-3.2-1B in bf16, then with ``quantization="w4a8"``, then
   W4A16 on the same engine and codes (every ``QuantLinear`` switched to
   its A16 route); Llama-3.2-3B with ``quantization="w4a8"`` and
   ``kv_cache_dtype="auto"``, which must resolve to int8 KV, then the same
   weights with bf16 KV; Llama-3.2-1B in bf16 with fp8 KV; Mistral-7B-v0.1
   (its published config, window 4096) in bf16 under
   ``attention_backend="auto"``, then under ``"pallas"`` on the same
   weights. Each serves greedy requests of different lengths, two that
   share a long prefix (radix hit), one longer than
   ``chunked_prefill_size``; Mistral-7B a 6,000-token prompt and a 4,090-token
   one whose decode crosses the window's edge (``WINDOW_REQUESTS``), and the
   window must move the long prompt's logits by at least ``WINDOW_MOVE``
   times the kernel-vs-plain reading against the plain path without it.
   Under ``pallas`` every decode launch goes through
   ``decode_attention_pallas``, under ``auto`` none. Toppings: after
   its own phase, the bf16 1B engine registers two LoRA adapters (rank 16,
   all seven targets, scaling 2.0) and one int8 delta adapter (q, v, gate
   and down of every layer) and serves the request set again with each
   request naming none or one of them (``1b-toppings``; the two prompts
   that share a prefix name different adapters and must not share KV); the
   W4A8 engine does the same after its W4A16 phase (``w4a8-toppings``, not
   timed). The delta kernel must launch once per projection and layer of
   every forward whose batch names an adapter.
   Every kernel's launch count is set to 0 just before and read just
   after; attention must launch at least layers x forwards of its mode
   (the 8-bit kernels for an 8-bit pool, and the bf16 ones never there),
   each W4 kernel of the route (6 x layers + 1) x forwards. The model's
   logits on the kernel path are held against the plain path (plain
   attention, plain W4 GEMMs and the plain delta function; not for the 3B
   engine with bf16 KV, whose kernels the others hold) for each prompt's
   first generated token and one decode step after it (the toppings
   engines: one mixed batch of none, LoRA and delta rows, extend and one
   decode step, where each adapter must also move its rows' logits by at
   least ``ADAPTER_MOVE`` times the reading): the argmax must agree on every row but
   those whose plain top-2 logits are equal or adjacent bf16 values (the
   logits are bf16, so ties occur), and max
   |diff| must stay within LOGIT_RTOL of max |logit|. After each
   engine's checks, while all checks hold: its decode tokens/s at batch 64
   with 128-token prompts and 128 new tokens, and the device's busy share
   of its decode steps: device time per step over three decode windows
   of a profiled run (``torch.profiler``) against the timed run's wall per
   step; the trace of those windows, exported and read back by
   ``tools/analyze_trace.py``, gives ``[profile <label>]`` lines of device
   time by category and the top 5 ops.
   Each engine's serving run, and the warm-up run of its bench batch,
   print a ``[prefill <label>]`` line: the extend forwards, their device ms
   (CUDA-event spans) and their wall ms (``tools/prefill_ab.py::
   PrefillTimer``).
   Phases 3 and 4 record a failed check and go on, so that a faulty
   kernel still shows every reading; the script exits non-zero after
   phase 4 if any check failed.
5. times, with the engines freed: each kernel's median device time at the
   main path's shapes, beside its bound (bytes at 3.35 TB/s, or operations
   at 989 TFLOP/s bf16 / 1,979 TOPS int8, whichever is larger), its plain
   version's time and one PyTorch call as a yardstick the port never calls
   (``scaled_dot_product_attention`` on K/V gathered dense, and dequantized
   to bf16, beforehand; ``torch.matmul`` of bf16 x with the weight
   dequantized to bf16 beforehand; for the delta kernel ``torch.bmm`` of
   each delta slot's rows with its panel dequantized and scaled to bf16
   beforehand), at 1B decode (bs 64, one and three delta slots) and one
   2048-token prefill chunk. At Mistral-7B's shape: decode at bs 64 and ctx
   4096 and 8192 without a window and 8192 with W 4096 (through both
   wrappers), the 2048-token extend chunk on 4096, 5120 and 8192 tokens
   without a window and on 8192 with it; the bound counts the live window
   only, the library call masks the window. And the host's microseconds per
   ``write_kv`` call into a bf16, int8 and fp8 pool. Then the
   kernel-profiling entry point, this slice's main path:
   ``tools/decode_ablate.py``'s ``main`` with its defaults, every launch
   count set to 0 just before and read just after; the probe must launch in
   every mode, 16 layers a chain, and the stage cuts and the decode kernel
   must launch. It prints the mode table (each mode's ms per 16 chained
   layers at the JAX probe's shape, its plain version's and its bounds) and
   the stage table (each cut's ms at the 1B, 3B and 7B decode shapes beside
   the full decode's bound).
6. one JSON line with every kernel's numbers, one with the engines', the
   ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
   {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from scratchpad_tpu_torch.tools.prefill_ab import MISTRAL_7B, PrefillTimer
from scratchpad_tpu_torch.tools.timing import BF16_FLOPS, bound_ms, device_ms

ROOT = Path(__file__).resolve().parent
# H100 SXM, dense (the memory rate and the bf16 rate are in tools/timing.py)
INT8_OPS = 1979e12
# Kernel vs plain version. Every kernel accumulates in f32 and rounds only
# its output to bf16, which moves a value by at most 2**-8 of itself; ATOL
# covers the order of the f32 sums. A kernel that drops one page of a
# 4096-token context misses this by far (PERF.md, Findings).
ATOL, RTOL = 1e-4, 2.0**-8
# Kernel-path vs plain-path logits, relative to the largest |logit|, by
# engine. bf16 and W4A16: each path rounds its attention and GEMM outputs
# to bf16 on its own, and the difference grows through 16 layers of random
# weights. Sound kernels read up to 1.585e-2 (bf16) and 1.812e-2 (W4A16); a
# decode kernel that drops its last page reads 5.2e-2 to 0.38, one that
# drops a page of the prefill 0.37 to 0.73 (PERF.md, Findings). W4A8 adds
# the int8 rounding of every GEMM's input: a bf16 ulp of difference
# upstream moves an x8 by one, and that moves an output by ax * |w|; sound
# kernels read up to 5.036e-2 there.
# The 8-bit KV engines quantize each new K/V row on each path, so a bf16
# ulp upstream moves a code by one, as an x8 of W4A8. Sound kernels read
# 5.500e-2 (3B W4A8, int8 KV) and 1.916e-2 (1B bf16, fp8 KV); a decode kernel
# without the V scale, or an extend kernel that scales V by the K scale,
# gives worst readings of 0.515 to 0.796 in both, and fp8 decode without
# the sign bit 1.526 (PERF.md, Findings). The 3B engine with bf16 KV is not
# compared.
LOGIT_RTOL = {
    "bf16": 3e-2, "w4a8": 1e-1, "w4a16": 3e-2, "3b-w4a8": 1e-1, "1b-fp8kv": 5e-2,
    "1b-toppings": 5e-2, "w4a8-toppings": 1e-1, "mistral-7b": 3e-2, "mistral-7b-pallas": 3e-2,
}
# The argmax must agree on every row but a bf16 tie at the top. W4A8 also
# excuses a row whose plain top-2 gap is at most this share of max |logit|:
# its sound kernels flip one row of the request set at a gap of 1.439e-2
# (PERF.md, Findings). A flip needs the two logits' differences to sum to
# the gap, so an excuse that scales with the row's own max |diff| would
# pass every flip; this one is a fixed floor. The 8-bit KV engines take it
# too, since each path quantizes its own K/V rows.
ARGMAX_FLOOR = {
    "bf16": 0.0, "w4a8": 2e-2, "w4a16": 0.0, "3b-w4a8": 2e-2, "1b-fp8kv": 2e-2,
    "1b-toppings": 3e-2, "w4a8-toppings": 3e-2, "mistral-7b": 0.0, "mistral-7b-pallas": 0.0,
}
# Each adapter must move its rows' logits (max|adapted - base| / max|base|)
# by at least this many times the engine's kernel-vs-plain reading, so that
# a kernel that adds nothing fails.
ADAPTER_MOVE = 10.0
# The same for a sliding window: the kernel path's logits of a prompt longer
# than the window against the plain path's without the window, so that a
# window that masks nothing fails.
WINDOW_MOVE = 10.0
# the toppings engines' requests, in the order of phase_engine's prompts
# and its second request: the last two share a 600-token prefix under
# different adapters
TOPPINGS = ["ad1", "dl1", None, "ad2", "ad1", "dl1", "ad2", "dl1"]
FAILURES: list[str] = []


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    """Record a failed correctness check and go on (see phase 4)."""
    if not ok:
        print(f"chip_smoke CHECK FAILED: {msg}", file=sys.stderr, flush=True)
        FAILURES.append(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- helpers


def seeded(seed: int):
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


def make_pool(lens, Hkv, D, ps, layers, gen):
    """Random bf16 K/V pools [layers, pages, ps, Hkv, D] and a page table
    whose pages are shuffled; page 0 is the dump page, like the engine's."""
    import torch

    B = len(lens)
    need = [max(-(-n // ps), 1) for n in lens]
    total = sum(need) + 1
    perm = torch.randperm(total - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(B, max(need), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[o : o + n].to(torch.int32)
        o += n
    shape = (layers, total, ps, Hkv, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, pt


def quant_pages(k, v, kind: str):
    """bf16 pages as they are (``kind`` "bf16"), or as int8 / fp8 codes with
    bf16 scales through the KV quantizer: (k, v, k_scale, v_scale). V is
    scaled down first, so that K and V scales differ."""
    import torch

    from scratchpad_tpu_torch.ops.attention import quantize_rows

    if kind == "bf16":
        return k, v, None, None
    code = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    kc, ks = quantize_rows(k, code)
    vc, vs = quantize_rows(v * 0.05, code)
    return kc, vc, ks, vs


def at(t, l: int):
    return None if t is None else t[l]


def decode_kernel(q, k, v, ks, vs, pt, lens, scale, cap=None, window=None):
    """The decode wrapper of the pages' kind."""
    from scratchpad_tpu_torch.ops.attention import paged_decode_attention, paged_decode_attention_quant

    if ks is None:
        return paged_decode_attention(q, k, v, pt, lens, scale, cap, window)
    return paged_decode_attention_quant(q, k, v, ks, vs, pt, lens, scale, cap, window)


def extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap=None, window=None):
    from scratchpad_tpu_torch.ops.attention import paged_extend_attention, paged_extend_attention_quant

    if ks is None:
        return paged_extend_attention(q, k, v, pt, kv_lens, cu, scale, cap, window)
    return paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)


# kernel of each attention route, by the pages' kind
DECODE = {"bf16": "paged_decode_attention", "int8": "paged_decode_attention_quant",
          "fp8": "paged_decode_attention_quant"}
EXTEND = {"bf16": "paged_extend_attention", "int8": "paged_extend_attention_quant",
          "fp8": "paged_extend_attention_quant"}


def max_err(out, ref) -> tuple[float, float]:
    """max |out - ref| and the largest ratio of |out - ref| to its
    tolerance (<= 1 passes); ``ref`` is the plain version's f32 output."""
    d = (out.float() - ref).abs()
    ratio = d / (ATOL + RTOL * ref.abs())
    return float(d.max()), float(ratio.max())


# ------------------------------------------------------------ phase 1 & 2


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(
        f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi_line


def sass_counts(sass: str, opcodes) -> dict:
    """How many instructions of each opcode a ``cuobjdump --dump-sass``
    listing holds (``/*0280*/ @!P1 HGMMA.64x64x16.F32.BF16 ...``)."""
    ops = []
    for line in sass.splitlines():
        words = line.split("*/", 1)[1].split() if line.lstrip().startswith("/*") and "*/" in line else []
        words = [w for w in words if not w.startswith("@")]
        if words:
            ops.append(words[0].split(".")[0])
    return {op: ops.count(op) for op in opcodes}


# the libraries whose SASS phase 2 counts: the extend kernel, and the two
# GEMMs on csrc/sm90_gemm.cuh, which must hold wgmma and asynchronous copies
SASS_LIBRARIES = ("paged_extend_attention", "w4a16_matmul", "delta_matmul")


def phase_build():
    from scratchpad_tpu_torch.ops.attention.gqa_decode import DECODE_STAGE_TARGETS
    from scratchpad_tpu_torch.utils import native

    t0 = time.monotonic()
    report = native.build(native.KERNEL_SOURCES + DECODE_STAGE_TARGETS)
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {time.monotonic() - t0:.1f} s")
    # what the tensor-core kernels run on: products (HGMMA is wgmma, HMMA
    # mma.sync) and asynchronous copies (LDGSTS is cp.async, UTMALDG a TMA
    # load), counted in their SASS
    for name in SASS_LIBRARIES:
        lib = native._lib_path(name)
        sass = subprocess.run(
            [str(Path(native.nvcc_path()).parent / "cuobjdump"), "--dump-sass", str(lib)],
            capture_output=True, text=True, timeout=300,
        )
        count = sass_counts(sass.stdout, ("HGMMA", "HMMA", "LDGSTS", "UTMALDG"))
        log(f"[sass] {lib.name}: " + ", ".join(f"{op} {n}" for op, n in count.items()))
        if sass.returncode != 0 or count["HGMMA"] + count["HMMA"] == 0:
            fail(f"the {name} library has no tensor-core instruction (cuobjdump rc {sass.returncode})")
        if name != "paged_extend_attention" and (
            count["HGMMA"] == 0 or count["LDGSTS"] + count["UTMALDG"] == 0
        ):
            fail(f"the {name} library has no wgmma or no asynchronous copy: {count}")


# --------------------------------------------------------------- phase 3


def check_decode(errs: dict) -> None:
    """bf16, int8 and fp8 pages; G = 4 (Hq 32) and G = 3 (Hq 24) over Hkv 8;
    head_dim 64 and 128; B 1 and 64 at contexts 256 and 4096, and a batch
    with padding rows, which must come out as exact zeros."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain

    Hkv, ps = 8, 16
    seed = 0
    for kind in ("bf16", "int8", "fp8"):
        for G in (4, 3):
            for D in (64, 128):
                cases = [(B, ctx) for B in (1, 64) for ctx in (256, 4096)] + [None]
                for case in cases:
                    seed += 1
                    gen = seeded(seed)
                    if case is None:  # padding rows: seq_len == 0
                        lens = torch.tensor([300, 0, 17, 0], dtype=torch.int32, device="cuda")
                    else:
                        B, ctx = case
                        lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
                        lens[0] = ctx
                        lens = lens.to(torch.int32)
                    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
                    k, v, ks, vs = quant_pages(k[0], v[0], kind)
                    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
                    scale = 1.0 / math.sqrt(D)
                    out = decode_kernel(q, k, v, ks, vs, pt, lens, scale)
                    ref = paged_decode_attention_plain(q.float(), k, v, pt, lens, scale, ks, vs)
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[lens == 0] == 0).all())
                    errs[DECODE[kind]] = max(errs[DECODE[kind]], e)
                    what = "padding rows" if case is None else f"B={case[0]} ctx={case[1]}"
                    log(
                        f"[check] decode {kind} G={G} D={D} {what}: max_abs_err {e:.3e}, "
                        f"max err/tol {ratio:.3f} (tol {ATOL}+{RTOL}*|ref|), zero rows exact: {zero}"
                    )
                    check(
                        ratio <= 1 and zero,
                        f"{kind} decode kernel disagrees with its plain version at G={G} D={D} {what}",
                    )


def extend_case(chunks, D, T_pad, seed, G=4):
    """chunks: (q_len, kv_len) per sequence; tokens past the chunks up to
    T_pad are padding."""
    import torch

    gen = seeded(seed)
    Hkv, ps = 8, 16
    q_lens = [c[0] for c in chunks]
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0).to(torch.int32)
    T = max(T_pad, sum(q_lens))
    k, v, pt = make_pool(kv_lens.tolist(), Hkv, D, ps, 1, gen)
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k[0], v[0], pt, kv_lens, cu


def check_extend(errs: dict) -> None:
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    cases = [
        # fresh prompt, chunk after a cached prefix, short tail, decode-like row
        ([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048),
        # a chunked prefill's second chunk next to fresh prompts, T = 4096
        ([(2048, 4096), (1500, 1500), (300, 845), (200, 200)], 4096),
    ]
    seed = 200
    worst = 0.0
    for kind in ("bf16", "int8", "fp8"):
        for G in (4, 3):
            for D in (64, 128):
                for chunks, T_pad in cases:
                    seed += 1
                    q, k, v, pt, kv_lens, cu = extend_case(chunks, D, T_pad, seed, G)
                    k, v, ks, vs = quant_pages(k, v, kind)
                    scale = 1.0 / math.sqrt(D)
                    out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale)
                    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs)
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    n_real = int(cu[-1])
                    zero = bool((out[n_real:] == 0).all())
                    errs[EXTEND[kind]] = max(errs[EXTEND[kind]], e)
                    worst = max(worst, ratio)
                    log(
                        f"[check] extend {kind} G={G} D={D} chunks={chunks} T={q.shape[0]}: "
                        f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, {q.shape[0] - n_real} "
                        f"padded tokens zero: {zero}"
                    )
                    check(
                        ratio <= 1 and zero,
                        f"{kind} extend kernel disagrees with its plain version at G={G} D={D} chunks={chunks}",
                    )
    log(f"[check] extend: worst err/tol {worst:.3f} over {seed - 200} cases")


# (logit_cap, sliding_window) of the windowed checks at Mistral-7B's shape:
# a cap alone, a window on a page edge (4096), edges inside a page and a
# 64-token KV tile (1000), both, and a window of one token
CAPS_WINDOWS = [(None, None), (50.0, None), (None, 4096), (None, 1000), (30.0, 1000), (None, 1)]
CAPS_WINDOWS_8BIT = [(30.0, 1000), (None, 4096)]
# q of the capped checks is scaled up so that scores reach the cap: at the
# N(0, 1) scores of unit q and K, a cap of 30 moves a score by under 1e-2,
# and a kernel that skips the cap read only 4.95x the tolerance (PERF.md,
# Findings)
CAP_Q_SCALE = 8.0


def capped_q(q, cap):
    return q if cap is None else (q.float() * CAP_Q_SCALE).to(q.dtype)


def cap_window(cap, window) -> str:
    return f"cap={cap} W={window}"


def check_window_decode(errs: dict) -> None:
    """The decode kernels with a soft cap and a static window at Mistral-7B's
    shape (Hq 32, Hkv 8, D 128, page 16): B 1 and 64 at contexts 256, 4096
    and 8192 (B 64 with two rows of length 0 and one of length 1), and a
    batch of padding rows; bf16 pages at every (cap, W) of ``CAPS_WINDOWS``,
    int8 and fp8 pages at those of ``CAPS_WINDOWS_8BIT``."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain

    Hkv, G, D, ps = 8, 4, 128, 16
    scale = 1.0 / math.sqrt(D)
    seed = 10_000
    for kind, grid in (("bf16", CAPS_WINDOWS), ("int8", CAPS_WINDOWS_8BIT), ("fp8", CAPS_WINDOWS_8BIT)):
        for case in [(B, ctx) for B in (1, 64) for ctx in (256, 4096, 8192)] + [None]:
            seed += 1
            gen = seeded(seed)
            if case is None:
                lens = torch.tensor([5000, 0, 17, 0], dtype=torch.int32, device="cuda")
            else:
                B, ctx = case
                lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
                lens[0] = ctx
                if B > 1:
                    lens[-3:] = torch.tensor([0, 1, 0], device="cuda")
                lens = lens.to(torch.int32)
            k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
            k, v, ks, vs = quant_pages(k[0], v[0], kind)
            q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            for cap, window in grid:
                qc = capped_q(q, cap)
                out = decode_kernel(qc, k, v, ks, vs, pt, lens, scale, cap, window)
                ref = paged_decode_attention_plain(qc.float(), k, v, pt, lens, scale, ks, vs, cap, window)
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[lens == 0] == 0).all())
                errs[DECODE[kind]] = max(errs[DECODE[kind]], e)
                what = "padding rows" if case is None else f"B={case[0]} ctx={case[1]}"
                log(
                    f"[check] decode {kind} Mistral shape {what} {cap_window(cap, window)}: "
                    f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}"
                )
                check(
                    ratio <= 1 and zero,
                    f"{kind} decode kernel disagrees with its plain version at the Mistral shape "
                    f"{what} {cap_window(cap, window)}",
                )
            del k, v, ks, vs


def check_window_extend(errs: dict) -> None:
    """The extend kernels with (cap, W) of (None, 4096) and (30, 1000) at
    Mistral-7B's shape: a 2048-token chunk on 6,000 cached tokens, and mixed
    chunks whose window edge falls inside a query tile and inside a page,
    beside a fresh prompt and padded tokens; bf16 pages, and int8 and fp8
    pages at (30, 1000)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    cases = [
        ([(2048, 8048)], 2048),
        ([(100, 1100), (37, 1037), (300, 300), (1, 5000), (250, 4346)], 720),
    ]
    scale = 1.0 / math.sqrt(128)
    seed = 11_000
    worst, n = 0.0, 0
    for kind, grid in (("bf16", [(None, 4096), (30.0, 1000)]), ("int8", [(30.0, 1000)]),
                       ("fp8", [(30.0, 1000)])):
        for chunks, T_pad in cases:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, 128, T_pad, seed, G=4)
            k, v, ks, vs = quant_pages(k, v, kind)
            n_real = int(cu[-1])
            for cap, window in grid:
                qc = capped_q(q, cap)
                out = extend_kernel(qc, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)
                ref = paged_extend_attention_plain(
                    qc.float(), k, v, pt, kv_lens, cu, scale, ks, vs, cap, window
                )
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[n_real:] == 0).all())
                errs[EXTEND[kind]] = max(errs[EXTEND[kind]], e)
                worst, n = max(worst, ratio), n + 1
                log(
                    f"[check] extend {kind} Mistral shape chunks={chunks} T={q.shape[0]} "
                    f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, "
                    f"{q.shape[0] - n_real} padded tokens zero: {zero}"
                )
                check(
                    ratio <= 1 and zero,
                    f"{kind} extend kernel disagrees with its plain version at the Mistral shape "
                    f"chunks={chunks} {cap_window(cap, window)}",
                )
            del k, v, ks, vs
    log(f"[check] extend at the Mistral shape, cap and window: worst err/tol {worst:.3f} over {n} cases")


def decode_meta(pt, lens):
    """A decode ``ForwardMeta`` over page table ``pt`` and lengths ``lens``,
    for the model-facing ``decode_attention_pallas`` (which reads only those
    two)."""
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode

    rows = torch.arange(len(lens), device="cuda")
    return ForwardMeta(
        mode=ForwardMode.DECODE, tokens=rows, positions=rows, out_cache_loc=rows,
        req_indices=rows, page_table=pt, seq_lens=lens, extend_lens=torch.ones_like(lens),
        last_token_idx=rows,
    )


def pallas_case(B: int, Hq: int, Hkv: int, D: int, ctx: int, gen):
    """q, a one-layer bf16 pool and a decode ``ForwardMeta`` for
    ``decode_attention_pallas``: B rows of up to ``ctx`` tokens at page 16,
    the last row of length 0 when B > 1."""
    import torch

    from scratchpad_tpu_torch.memory.kv_cache import KVCache

    lens = torch.randint(max(ctx // 2, 1), ctx + 1, (B,), generator=gen, device="cuda")
    lens[0] = ctx
    if B > 1:
        lens[-1] = 0
    lens = lens.to(torch.int32)
    k, v, pt = make_pool(lens.tolist(), Hkv, D, 16, 1, gen)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, KVCache(k, v), decode_meta(pt, lens)


def check_pallas_decode(errs: dict) -> None:
    """Row 9's wrapper, ``decode_attention_pallas``, at its JAX test's shape
    (``tests/test_pallas_kernels.py::make_case``: B 4, Hq 8, Hkv 2, D 64,
    page 16, up to 256 tokens) with cap 30 and window 8, and at Mistral-7B's
    decode shape (B 64, ctx 8192, W 4096), against the plain version; its
    launch count must rise once a call."""
    from scratchpad_tpu_torch.ops.attention import decode_attention_pallas, paged_decode_attention_plain

    for i, (B, Hq, Hkv, D, ctx, cap, window) in enumerate(
        [(4, 8, 2, 64, 256, 30.0, 8), (64, 32, 8, 128, 8192, None, 4096)]
    ):
        q, kv, meta = pallas_case(B, Hq, Hkv, D, ctx, seeded(12_000 + i))
        q = capped_q(q, cap)
        before = decode_attention_pallas.launches
        scale = 1.0 / math.sqrt(D)
        out = decode_attention_pallas(q, kv, 0, meta, sm_scale=scale, logit_cap=cap, sliding_window=window)
        counted = decode_attention_pallas.launches - before
        ref = paged_decode_attention_plain(
            q.float(), kv.k[0], kv.v[0], meta.page_table, meta.seq_lens, scale, None, None, cap, window
        )
        e, ratio = max_err(out, ref)
        zero = bool((out[meta.seq_lens == 0] == 0).all())
        errs["decode_attention_pallas"] = max(errs["decode_attention_pallas"], e)
        log(
            f"[check] decode_attention_pallas B={B} Hq={Hq} Hkv={Hkv} D={D} ctx={ctx} "
            f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows "
            f"exact: {zero}, launches counted: {counted}"
        )
        check(ratio <= 1 and zero and counted == 1,
              f"decode_attention_pallas disagrees with its plain version at B={B} D={D}")


def check_kv_quantizer() -> None:
    """The KV quantizer (plain PyTorch on both devices) on the card against
    itself on the CPU, bit for bit: Llama-3.2-3B's K/V rows of a 2048-token
    chunk over six decades, a zero row, and rows whose bf16 scale rounds down
    so that |x / scale| passes the code range (127.49 and 449.7)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import quantize_rows

    gen = seeded(600)
    x = torch.randn(2048, 8, 128, generator=gen, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, (2048, 8, 1), generator=gen, device="cuda")
    x[5] = 0
    for kind, code, limit in (("int8", torch.int8, 127.0), ("fp8", torch.float8_e4m3fn, 448.0)):
        x[9] = 0
        x[9, :, :16] = torch.linspace(-limit * 1.0039, limit * 1.0039, 16, device="cuda")
        for xb in (x.to(torch.bfloat16), x):
            codes, scale = quantize_rows(xb, code)
            ref_codes, ref_scale = quantize_rows(xb.cpu(), code)
            torch.cuda.synchronize()
            n_diff = int((codes.view(torch.uint8).cpu() != ref_codes.view(torch.uint8)).sum())
            s_diff = int((scale.cpu() != ref_scale).sum())
            finite = bool(torch.isfinite(codes.float()).all())
            log(
                f"[check] kv quantizer {kind} on {xb.dtype} rows [2048, 8, 128]: {n_diff} codes "
                f"and {s_diff} scales differ from the CPU; all codes finite: {finite}"
            )
            check(n_diff == 0 and s_diff == 0 and finite, f"{kind} KV quantizer on the card differs from the CPU")


def llama_1b_matrices():
    """(name, In, Out, calls per forward) of Llama-3.2-1B's quantized
    matrices: six per layer, gate|up fused, and the tied head."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    c = get_preset("llama-3.2-1b")
    H, I, V, L = c.hidden_size, c.intermediate_size, c.vocab_size, c.num_hidden_layers
    q_out, kv_out = c.num_attention_heads * c.head_dim, c.num_kv_heads * c.head_dim
    return [
        ("wq", H, q_out, L), ("wk", H, kv_out, L), ("wv", H, kv_out, L), ("wo", q_out, H, L),
        ("gate_up", H, 2 * I, L), ("down", I, H, L), ("lm_head", H, V, 1),
    ]


def random_w4(In: int, Out: int, copies: int, gen):
    """``copies`` random weights [In -> Out] in the packed layout, with the
    group and stored width ``quantize_stacked`` gives such a matrix: random
    code bytes, bf16 scales in [0.005, 0.02), zero points 0..15 (stored
    minus 8)."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import padded_in
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size, stacked_out_width

    g = stacked_group_size(In)
    N, _ = stacked_out_width(Out)
    G = In // g
    q = torch.randint(0, 256, (copies, N, padded_in(In) // 2), generator=gen, device="cuda",
                      dtype=torch.uint8)
    s = (torch.rand(copies, G, N, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
    z = (torch.randint(0, 16, (copies, G, N), generator=gen, device="cuda") - 8).to(torch.bfloat16)
    return q, s, z, g


# M of the W4 checks at Llama-3.2-1B's matrices: decode, the edges of the
# W4A16 launch plan (64 | 65 rows, one and two 128-row tiles), a prefill chunk
W4_CHECK_M = (1, 64, 65, 129, 200, 2048)


def check_w4(errs: dict) -> None:
    """The row quantizer bit for bit, and both W4 GEMMs against their plain
    versions on the same int8 rows (W4A8) or bf16 rows (W4A16), at
    Llama-3.2-1B's seven matrices and each M of ``W4_CHECK_M``; at GPT-OSS's
    2880 -> 5760 (g 120) and at 1800 -> 1000 (g 100, Out padded to 1024).
    Row M // 2 is zeros: its outputs must be exact zeros. Where the W4A16
    plan splits K, a second call must give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        quantize_activations_plain,
        quantize_rows_int8,
        w4a8_matmul,
        w4a8_matmul_plain,
        w4a16_matmul,
        w4a16_matmul_plain,
        w4a16_plan,
    )

    cases = [(name, In, Out, M) for name, In, Out, _ in llama_1b_matrices() for M in W4_CHECK_M]
    cases += [("gpt-oss gate_up", 2880, 5760, M) for M in (1, 64, 300)]
    cases += [("g100", 1800, 1000, M) for M in (1, 64, 300)]
    for i, (name, In, Out, M) in enumerate(cases):
        gen = seeded(3000 + i)
        q, s, z, g = random_w4(In, Out, 1, gen)
        q, s, z = q[0], s[0], z[0]
        x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
        zero = M // 2 if M > 1 else None
        if zero is not None:
            x[zero] = 0
        x8, ax, gsum = quantize_rows_int8(x, g)
        ref = quantize_activations_plain(x, g)
        exact = all(torch.equal(a, b) for a, b in zip((x8, ax, gsum), ref))
        n_diff = int((x8 != ref[0]).sum())
        eq = max(float((a.float() - b.float()).abs().max()) for a, b in zip((x8, ax, gsum), ref))
        y8 = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
        e8, r8 = max_err(y8, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
        y16 = w4a16_matmul(x, q, s, z, g, Out)
        e16, r16 = max_err(y16, w4a16_matmul_plain(x, q, s, z, g, Out))
        plan = w4a16_plan(M, Out, In, g, s.shape[1])
        split = plan is not None and plan.splits > 1
        same = not split or torch.equal(y16, w4a16_matmul(x, q, s, z, g, Out))
        torch.cuda.synchronize()
        zeros = zero is None or bool((y8[zero] == 0).all() and (y16[zero] == 0).all())
        errs["quantize_rows_int8"] = max(errs["quantize_rows_int8"], eq)
        errs["w4a8_matmul"] = max(errs["w4a8_matmul"], e8)
        errs["w4a16_matmul"] = max(errs["w4a16_matmul"], e16)
        log(
            f"[check] w4 {name} {In}->{Out} g={g} M={M}: quantizer exact {exact} "
            f"({n_diff} x8 differ); w4a8 max_abs_err {e8:.3e}, err/tol {r8:.3f}; "
            f"w4a16 max_abs_err {e16:.3e}, err/tol {r16:.3f}; zero row exact: {zeros}"
            + (f"; split K {plan.splits}, second call bit-equal: {same}" if split else "")
        )
        check(exact, f"row quantizer differs from its plain version at {name} M={M}")
        check(r8 <= 1 and zeros, f"w4a8 kernel disagrees with its plain version at {name} M={M}")
        check(r16 <= 1 and zeros, f"w4a16 kernel disagrees with its plain version at {name} M={M}")
        check(same, f"w4a16 split-K calls differ at {name} M={M}")
        del q, s, z, x, x8, y8, y16
        torch.cuda.empty_cache()


def llama_1b_projections():
    """(name, In, Out, calls per forward) of Llama-3.2-1B's distinct
    projection shapes, as the toppings pools keep them (gate and up apart)."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    c = get_preset("llama-3.2-1b")
    H, I, L = c.hidden_size, c.intermediate_size, c.num_hidden_layers
    q_out, kv_out = c.num_attention_heads * c.head_dim, c.num_kv_heads * c.head_dim
    assert q_out == H
    return [
        ("wq|wo", H, q_out, 2 * L), ("wk|wv", H, kv_out, 2 * L),
        ("gate|up", H, I, 2 * L), ("down", I, H, L),
    ]


# pool adapters of the delta checks: 3 and 0 carry no delta (3 is LoRA only)
DELTA_HAS = [0, 1, 1, 0, 1, 1, 1, 1]
# (active_adapters, the slots tokens take)
DELTA_LAYOUTS = {
    "one slot": ([0, 2, 0, 0, 0, 0, 0, 0], [1]),
    "all eight mixed": ([0, 1, 2, 3, 4, 5, 6, 7], list(range(8))),
    "a slot with no tokens": ([0, 1, 2, 4, 0, 0, 0, 0], [0, 1, 3]),
    "a LoRA-only slot": ([0, 3, 0, 0, 0, 0, 0, 0], [0, 1]),
    "no adapter": ([0] * 8, [0]),
}


def delta_pool(In: int, Out: int, layers: int, gen, N: int = 8):
    """A random delta pool like the manager's: int8 codes ``[N, layers, In,
    Out]`` (slot 0 zero) and f32 per-out-channel scales, with the flags of
    ``DELTA_HAS`` and scalings 0.5 to 2.0."""
    import torch

    dq = torch.randint(-127, 128, (N, layers, In, Out), generator=gen, device="cuda", dtype=torch.int8)
    dq[0] = 0
    ds = torch.rand(N, layers, Out, generator=gen, device="cuda") * 2e-3
    has = torch.tensor(DELTA_HAS[:N], dtype=torch.int32, device="cuda")
    return dq, ds, has, torch.linspace(0.5, 2.0, N, device="cuda")


def delta_rows(T: int, choices, gen):
    import torch

    pick = torch.randint(0, len(choices), (T,), generator=gen, device="cuda")
    return torch.tensor(choices, dtype=torch.int32, device="cuda")[pick]


# tokens of the delta checks: decode, the launch plan's edges (64 | 65 rows,
# 128 | 129), a prefill chunk; and an Out that no tile width divides
DELTA_CHECK_T = (1, 7, 64, 65, 129, 2048)
DELTA_EDGE = ("out 1000", 2048, 1000, 0)


def check_delta(errs: dict) -> None:
    """The grouped delta kernel against its plain version's f32 sums on
    the rows of delta slots, at Llama-3.2-1B's projection shapes and at
    ``DELTA_EDGE``, each T of ``DELTA_CHECK_T`` and every layout of
    ``DELTA_LAYOUTS``; every other row must come out bit-equal to the input.
    Where the plan splits K, a second call must give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, delta_matmul_grouped_plain
    from scratchpad_tpu_torch.ops.quant.w4_matmul import gemm_plan

    for i, (name, In, Out, _) in enumerate(llama_1b_projections() + [DELTA_EDGE]):
        gen = seeded(8000 + i)
        dq, ds, has, scaling = delta_pool(In, Out, 3, gen)  # checked at layer 1 of 3
        for T in DELTA_CHECK_T:
            x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
            out0 = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
            for layout, (active, choices) in DELTA_LAYOUTS.items():
                act = torch.tensor(active, dtype=torch.int32, device="cuda")
                slots = delta_rows(T, choices, gen)
                args = (x, dq, ds, 1, act, has, scaling, slots)
                got = delta_matmul_grouped(out0.clone(), *args)
                ref = delta_matmul_grouped_plain(out0.float(), *args)
                splits = gemm_plan(T, Out, In, slots=len(active) - 1).splits
                same = splits == 1 or torch.equal(got, delta_matmul_grouped(out0.clone(), *args))
                torch.cuda.synchronize()
                touched = (slots > 0) & (has[act[slots].long()] > 0)
                e, ratio = max_err(got[touched], ref[touched]) if bool(touched.any()) else (0.0, 0.0)
                kept = bool(torch.equal(got[~touched], out0[~touched]))
                errs["delta_matmul_grouped"] = max(errs["delta_matmul_grouped"], e)
                log(
                    f"[check] delta {name} {In}->{Out} T={T} {layout}: {int(touched.sum())} rows in "
                    f"delta slots, max_abs_err {e:.3e}, err/tol {ratio:.3f}; other rows bit-equal: {kept}"
                    + (f"; split K {splits}, second call bit-equal: {same}" if splits > 1 else "")
                )
                check(
                    ratio <= 1 and kept,
                    f"delta kernel disagrees with its plain version at {name} T={T} {layout}",
                )
                check(same, f"delta split-K calls differ at {name} T={T} {layout}")
        del dq, ds
        torch.cuda.empty_cache()


def bf16_ulp_err(out, ref) -> tuple[float, float]:
    """max |out - ref| of two bf16 tensors and its largest ratio to one bf16
    ulp of ``ref`` (<= 1 passes)."""
    import torch

    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    d = (out.float() - r).abs()
    return float(d.max()), float((d / ulp).max())


def check_decode_ablate(errs: dict) -> None:
    """Row 10, the decode ablation probe, against its plain version in all
    five modes: B 64, Hkv 8, page 16, 16-page chunks, at the JAX probe's ctx
    192 and at ctx 1000 (4 chunks, edges inside the rows), rows of up to
    ctx tokens with one of 0 and one of 1; G 3 and 4, Dp 64 and 128, over a
    random pool and page table. ``out`` within one bf16 ulp, ``aux`` within
    ``aux_tolerance`` (m exact); one launch a call."""
    import torch

    from scratchpad_tpu_torch.ops.attention import decode_ablate, decode_ablate_plain
    from scratchpad_tpu_torch.ops.attention.decode_ablate import MODES, aux_tolerance

    B, Hkv, ps, CP = 64, 8, 16, 16
    seed = 14_000
    for ctx in (192, 1000):
        for G in (3, 4):
            for Dp in (64, 128):
                seed += 1
                gen = seeded(seed)
                P = -(-ctx // (CP * ps)) * CP
                pages = B * P + 1
                kv = torch.randn(pages, ps, 2 * Hkv, Dp, generator=gen, device="cuda").to(torch.bfloat16)
                pt = torch.randint(0, pages, (B, P), generator=gen, device="cuda", dtype=torch.int32)
                q = torch.randn(B, Hkv * G, Dp, generator=gen, device="cuda").to(torch.bfloat16)
                lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
                lens[0], lens[1], lens[2] = ctx, 0, 1
                lens = lens.to(torch.int32)
                for mode in MODES:
                    before = decode_ablate.launches
                    out, aux = decode_ablate(q, kv, pt, lens, mode)
                    counted = decode_ablate.launches - before
                    ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode)
                    torch.cuda.synchronize()
                    e, ulps = bf16_ulp_err(out, ref_out)
                    tol = aux_tolerance(ref_aux, mode, ATOL)
                    d = (aux - ref_aux).abs()
                    m_exact = bool((d[..., 0] == 0).all())
                    aux_ratio = float((d[..., 1:] / tol[..., 1:]).max())
                    errs["decode_ablate"] = max(errs["decode_ablate"], e)
                    log(
                        f"[check] decode_ablate {mode} ctx={ctx} G={G} Dp={Dp}: out max_abs_err "
                        f"{e:.3e} ({ulps:.2f} bf16 ulp), aux m exact: {m_exact}, aux l/checksum "
                        f"max err/tol {aux_ratio:.3f}, launches counted: {counted}"
                    )
                    check(ulps <= 1 and m_exact and aux_ratio <= 1 and counted == 1,
                          f"decode_ablate {mode} disagrees with its plain version at ctx={ctx} "
                          f"G={G} Dp={Dp}")
                del kv
    torch.cuda.empty_cache()


def check_decode_stages() -> None:
    """The decode kernel's stage cuts (variant libraries: stages 1, 2, 3 and
    5) against their plain functions at every shape the stage table times
    (``tools/decode_ablate.STAGE_SHAPES``: Llama-3.2-1B, 3B and Mistral-7B):
    B 64, ctx 4096, page 16, Hkv 8, lengths down to 2048 and one padding
    row."""
    import torch

    from scratchpad_tpu_torch.ops.attention.gqa_decode import (
        DECODE_STAGES,
        paged_decode_attention_stage,
        paged_decode_attention_stage_plain,
    )
    from scratchpad_tpu_torch.tools.decode_ablate import STAGE_SHAPES

    for label, (G, D) in STAGE_SHAPES.items():
        gen = seeded(15_000 + G + D)
        lens = torch.randint(2048, 4097, (64,), generator=gen, device="cuda")
        lens[0], lens[1] = 4096, 0
        lens = lens.to(torch.int32)
        k, v, pt = make_pool(lens.tolist(), 8, D, 16, 1, gen)
        q = torch.randn(64, 8 * G, D, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        for stage in (s for s in DECODE_STAGES if s != 4):
            out = paged_decode_attention_stage(stage, q, k[0], v[0], pt, lens, scale)
            ref = paged_decode_attention_stage_plain(stage, q, k[0], v[0], pt, lens, scale)
            torch.cuda.synchronize()
            e, ratio = max_err(out, ref)
            zero = bool((out[lens == 0] == 0).all())
            log(f"[check] decode stage {stage} {label} G={G} D={D} B=64 ctx=4096: max_abs_err "
                f"{e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}")
            check(ratio <= 1 and zero,
                  f"decode stage {stage} disagrees with its plain function at {label}")
        del k, v
        torch.cuda.empty_cache()


# --------------------------------------------------------- phase 5 (kernels)


def dense_kv(cache, scale, pt, ps: int, B: int, n: int):
    """The first n cached tokens of each sequence as dense bf16 [B, Hkv, n,
    D] (dequantized for 8-bit pages), for the library yardstick."""
    import torch

    from scratchpad_tpu_torch.ops.attention.gqa_decode import gather_kv_rows

    slots = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(B, -1)[:, :n]
    return gather_kv_rows(cache, scale, slots).to(torch.bfloat16).transpose(1, 2).contiguous()


def time_decode(B: int, ctx: int, D: int = 64, G: int = 4, kind: str = "bf16",
                window=None, wrapper: str = "auto") -> dict:
    """Decode at page 16 over Hkv 8: Llama-3.2-1B is G 4, D 64; 3B is G 3,
    D 128; Mistral-7B G 4, D 128, with its window of 4096. ``kind``: bf16
    pages, or int8 / fp8 codes with bf16 scales. ``wrapper`` "pallas": the
    kernel through ``decode_attention_pallas`` (row 9). The bound counts
    the bytes and operations of the live window only; the library call
    attends over every token, the window as its ``attn_mask``."""
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.memory.kv_cache import KVCache
    from scratchpad_tpu_torch.ops.attention import decode_attention_pallas, paged_decode_attention_plain

    Hkv, ps = 8, 16
    elem = 2 if kind == "bf16" else 1
    per_layer = B * ctx * Hkv * D * 2 * elem
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(1000 + B + ctx + D + G)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, layers, gen)
    k, v, ks, vs = quant_pages(k, v, kind)
    q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    if wrapper == "pallas":
        meta, pool = decode_meta(pt, lens), KVCache(k, v)
        kern = lambda l: decode_attention_pallas(q, pool, l, meta, sm_scale=scale, sliding_window=window)
    else:
        kern = lambda l: decode_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, lens, scale, None, window)
    plain = lambda l: paged_decode_attention_plain(
        q, k[l], v[l], pt, lens, scale, at(ks, l), at(vs, l), None, window
    )
    # dense [B, Hkv, S, D] bf16 copies for the library call, made once
    kd = [dense_kv(k[l], at(ks, l), pt, ps, B, ctx) for l in range(layers)]
    vd = [dense_kv(v[l], at(vs, l), pt, ps, B, ctx) for l in range(layers)]
    q4 = q.view(B, Hkv * G, 1, D)
    mask = None
    if window is not None:
        mask = (torch.arange(ctx, device="cuda") >= ctx - window)[None, None, None, :]
    lib = lambda l: F.scaled_dot_product_attention(
        q4, kd[l], vd[l], attn_mask=mask, scale=scale, enable_gqa=True
    )
    live = min(ctx, window or ctx)
    kv_bytes = B * live * Hkv * 2 * (D * elem + (0 if kind == "bf16" else 2))
    nbytes = q.numel() * 2 * 2 + kv_bytes + pt.numel() * 4 + B * 4
    flops = 4.0 * B * live * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"{kind} pages, B={B} ctx={ctx} window={window} Hq={Hkv * G} Hkv={Hkv} D={D} "
        f"page={ps}" + (" (decode_attention_pallas)" if wrapper == "pallas" else ""),
        ms=device_ms(kern, layers, 50),
        plain_ms=device_ms(plain, layers, 5),
        library_ms=device_ms(lib, layers, 50),
        bound_ms=b,
        bound_by=by,
    )
    del kd, vd, k, v
    torch.cuda.empty_cache()
    return r


def time_extend(chunks, D: int = 64, G: int = 4, kind: str = "bf16", window=None) -> dict:
    """The extend at page 16 over Hkv 8; with ``window``, the bound counts
    the keys some query's window holds and the pairs the windows attend."""
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    Hkv, ps = 8, 16
    elem = 2 if kind == "bf16" else 1
    kv_total = sum(c[1] for c in chunks)
    per_layer = kv_total * Hkv * D * 2 * elem
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(2000 + len(chunks) + D + G)
    q_lens = [c[0] for c in chunks]
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0).to(torch.int32)
    T = sum(q_lens)
    k, v, pt = make_pool(kv_lens.tolist(), Hkv, D, ps, layers, gen)
    k, v, ks, vs = quant_pages(k, v, kind)
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    kern = lambda l: extend_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, kv_lens, cu, scale, None, window)
    plain = lambda l: paged_extend_attention_plain(
        q, k[l], v[l], pt, kv_lens, cu, scale, at(ks, l), at(vs, l), None, window
    )
    # library yardstick: one SDPA call over the batch when every sequence
    # has the same (q_len, kv_len), with the tail-aligned causal mask
    assert len(set(chunks)) == 1, "library yardstick needs one (q_len, kv_len)"
    ql, kl = chunks[0]
    B = len(chunks)
    kd = [dense_kv(k[l], at(ks, l), pt, ps, B, kl) for l in range(layers)]
    vd = [dense_kv(v[l], at(vs, l), pt, ps, B, kl) for l in range(layers)]
    qd = q.view(B, ql, Hkv * G, D).transpose(1, 2).contiguous()
    if ql == kl and window is None:
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], is_causal=True, scale=scale, enable_gqa=True
        )
    else:
        j = torch.arange(kl, device="cuda")[None, :]
        p = (kl - ql + torch.arange(ql, device="cuda"))[:, None]
        mask = (j <= p) & (j > p - (window or kl + 1))
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], attn_mask=mask, scale=scale, enable_gqa=True
        )
    # pairs (query, key) attended, and the keys some query's window holds
    W = window or max(c[1] for c in chunks) + 1
    attended = sum(min(p_ + 1, W) for q_, k_ in chunks for p_ in range(k_ - q_, k_))
    live = sum(k_ - max(k_ - q_ - W + 1, 0) for q_, k_ in chunks)
    kv_bytes = live * Hkv * 2 * (D * elem + (0 if kind == "bf16" else 2))
    nbytes = T * Hkv * G * D * 2 * 2 + kv_bytes + pt.numel() * 4
    flops = 4.0 * attended * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"{kind} pages, {len(chunks)} x (q_len {ql}, kv_len {kl}) window={window} "
        f"Hq={Hkv * G} Hkv={Hkv} D={D} page={ps}",
        ms=device_ms(kern, layers, 10),
        plain_ms=device_ms(plain, layers, 2, reps=3),
        library_ms=device_ms(lib, layers, 10),
        bound_ms=b,
        bound_by=by,
    )
    del kd, vd, k, v
    torch.cuda.empty_cache()
    return r


def time_w4(name: str, In: int, Out: int, M: int) -> dict:
    """Both W4 GEMMs at one matrix and M: median device ms beside the bound,
    the plain versions and ``torch.matmul`` of bf16 x with the weight
    dequantized to bf16 beforehand (a yardstick the port never calls).
    Calls cycle over enough weight copies (up to 128 MiB of codes) that the
    weights do not stay in L2, as on the main path."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        padded_in,
        quantize_rows_int8,
        unpack_w4,
        w4a8_matmul,
        w4a8_matmul_plain,
        w4a16_matmul,
        w4a16_matmul_plain,
    )

    Kp = padded_in(In)
    copies = max(2, min(64, -(-128 * 2**20 // (Out * Kp // 2))))
    gen = seeded(4000 + In + Out + M)
    q, s, z, g = random_w4(In, Out, copies, gen)
    G = In // g
    x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
    x8, ax, gsum = quantize_rows_int8(x, g)
    deq = [
        ((unpack_w4(q[l], In)[:, :Out].float() - z[l, :, :Out].float().repeat_interleave(g, 0))
         * s[l, :, :Out].float().repeat_interleave(g, 0)).to(torch.bfloat16)
        for l in range(min(copies, max(2, -(-256 * 2**20 // (In * Out * 2)))))
    ]
    iters = 50 if M <= 64 else 10
    w_bytes = Out * In / 2 + 2 * G * Out * 2
    a8_bytes = M * Kp + M * 4 + M * G * 4 + w_bytes + M * Out * 2
    a16_bytes = M * In * 2 + w_bytes + M * Out * 2
    ops = 2.0 * M * In * Out
    r = dict(shape=f"{name} {In}->{Out} g={g} M={M}")
    r["w4a8_matmul"] = dict(
        ms=device_ms(lambda l: w4a8_matmul(x8, ax, gsum, q[l], s[l], z[l], g, Out), copies, iters),
        plain_ms=device_ms(lambda l: w4a8_matmul_plain(x8, ax, gsum, q[l], s[l], z[l], g, Out), copies, 2, reps=3),
        library_ms=device_ms(lambda l: torch.matmul(x, deq[l % len(deq)]), len(deq), iters),
        nbytes=a8_bytes, ops=ops, peak=INT8_OPS,
    )
    r["w4a16_matmul"] = dict(
        ms=device_ms(lambda l: w4a16_matmul(x, q[l], s[l], z[l], g, Out), copies, iters),
        plain_ms=device_ms(lambda l: w4a16_matmul_plain(x, q[l], s[l], z[l], g, Out), copies, 2, reps=3),
        library_ms=r["w4a8_matmul"]["library_ms"],
        nbytes=a16_bytes, ops=ops, peak=BF16_FLOPS,
    )
    for t in (r["w4a8_matmul"], r["w4a16_matmul"]):
        t["bound_ms"], t["bound_by"] = bound_ms(t["nbytes"], t["ops"], t["peak"])
    del q, s, z, deq
    torch.cuda.empty_cache()
    return r


def time_quantizer(In: int, M: int) -> dict:
    """The row quantizer at one (M, In), g 128: bytes bound (x read, x8, ax
    and gsum written); no single PyTorch call computes it."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        padded_in,
        quantize_activations_plain,
        quantize_rows_int8,
    )

    copies = max(2, min(64, -(-128 * 2**20 // (M * In * 2))))
    xs = torch.randn(copies, M, In, generator=seeded(5000 + In + M), device="cuda").to(torch.bfloat16)
    nbytes = M * In * 2 + M * padded_in(In) + M * 4 + M * (In // 128) * 4
    b, by = bound_ms(nbytes, 0.0)
    r = dict(
        shape=f"M={M} In={In} g=128",
        ms=device_ms(lambda l: quantize_rows_int8(xs[l], 128), copies, 50),
        plain_ms=device_ms(lambda l: quantize_activations_plain(xs[l], 128), copies, 5),
        library_ms=None,
        bound_ms=b,
        bound_by=by,
    )
    del xs
    torch.cuda.empty_cache()
    return r


def phase_w4_timing() -> dict:
    """Every W4 matrix of Llama-3.2-1B at decode (M = 64) and prefill
    (M = 8192, the bench prefill of 64 x 128) shapes; the head at M = 64
    only, since it runs on each sequence's last token. Per kernel, the
    per-forward sums at bs 64 (calls x ms over the seven matrices) go to the
    ``kernels`` line. The groups that the JAX package's u8 half-plane
    kernels served (120 at GPT-OSS's 2880 -> 5760, and 100) are timed at
    M = 64 beside them, outside those sums."""
    rows = []
    shapes = [
        (name, In, Out, calls, M)
        for name, In, Out, calls in llama_1b_matrices()
        for M in ((64,) if name == "lm_head" else (64, 8192))
    ]
    shapes += [("gpt-oss gate_up", 2880, 5760, 0, 64), ("g100", 1800, 1000, 0, 64)]
    for name, In, Out, calls, M in shapes:
        r = time_w4(name, In, Out, M)
        r["calls"] = calls
        rows.append(r)
        for k in ("w4a8_matmul", "w4a16_matmul"):
            t = r[k]
            log(
                f"[time] {k} {r['shape']}: {t['ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; torch.matmul bf16 "
                f"{t['library_ms']:.4f} ms"
            )
    quant = {(In, M): time_quantizer(In, M) for In in (2048, 8192) for M in (64, 8192)}
    for r in quant.values():
        log(
            f"[time] quantize_rows_int8 {r['shape']}: {r['ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms"
        )
    per_fwd = {}
    dec = [r for r in rows if r["shape"].endswith("M=64")]
    for k in ("w4a8_matmul", "w4a16_matmul"):
        total = {
            f: sum(r["calls"] * r[k][f] for r in dec)
            for f in ("ms", "plain_ms", "library_ms", "nbytes", "ops")
        }
        per_fwd[k] = dict(
            shape="one decode forward of Llama-3.2-1B at bs 64 (6 matrices x 16 layers + head)",
            **{f: total[f] for f in ("ms", "plain_ms", "library_ms")},
        )
        per_fwd[k]["bound_ms"], per_fwd[k]["bound_by"] = bound_ms(
            total["nbytes"], total["ops"], dec[0][k]["peak"]
        )
    # per forward: 5 of the 6 per-layer inputs and the head's are 2048 wide
    n2048, n8192 = 5 * 16 + 1, 16
    a, b = quant[(2048, 64)], quant[(8192, 64)]
    per_fwd["quantize_rows_int8"] = dict(
        shape="one decode forward of Llama-3.2-1B at bs 64 (81 calls at In 2048, 16 at In 8192)",
        **{f: n2048 * a[f] + n8192 * b[f] for f in ("ms", "plain_ms", "bound_ms")},
        library_ms=None,
        bound_by="bytes",
    )
    return dict(rows=rows, quant=quant, per_forward=per_fwd)


def time_delta(In: int, Out: int, T: int, n_delta: int) -> dict:
    """The grouped delta kernel at one projection: T rows spread round-robin
    over slots 0..3 (the engine bench's none, LoRA, LoRA, delta) with
    ``n_delta`` of slots 1..3 holding a delta adapter, or, for
    ``n_delta == 0``, one prefill chunk of T rows all in one delta slot.
    Bound: the bytes of each active delta slot's panel, scales, rows of x
    and rows of out read and written, or 2 * rows * In * Out operations at
    the bf16 rate. Library yardstick: ``torch.bmm`` of each delta slot's rows
    with its panel dequantized and scaled to bf16 beforehand. Calls cycle
    over enough layers (up to 128 MiB of codes) to leave L2 cold."""
    import torch

    from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, delta_matmul_grouped_plain

    layers = max(2, min(64, -(-128 * 2**20 // (In * Out))))
    gen = seeded(9000 + In + Out + T + n_delta)
    dq, ds, _, scaling = delta_pool(In, Out, layers, gen, N=4)
    if n_delta:
        has = torch.tensor([0] + [int(j >= 4 - n_delta) for j in range(1, 4)], dtype=torch.int32, device="cuda")
        slots = (torch.arange(T, device="cuda") % 4).to(torch.int32)
    else:
        has = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device="cuda")
        slots = torch.ones(T, dtype=torch.int32, device="cuda")
    act = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
    delta_slots = [j for j in range(1, 4) if int(has[j])]
    rows = [(slots == j).nonzero()[:, 0] for j in delta_slots]
    n_rows = sum(len(r) for r in rows)
    xs = torch.stack([x[r] * scaling[j] for r, j in zip(rows, delta_slots)]).to(torch.bfloat16)
    n_lib = max(2, min(layers, -(-256 * 2**20 // (len(delta_slots) * In * Out * 2))))
    deq = [
        torch.stack([(dq[j, l].float() * ds[j, l]).to(torch.bfloat16) for j in delta_slots])
        for l in range(n_lib)
    ]
    args = lambda l: (x, dq, ds, l, act, has, scaling, slots)
    nbytes = len(delta_slots) * (In * Out + Out * 4) + n_rows * (In * 2 + Out * 2 * 2)
    b, by = bound_ms(nbytes, 2.0 * n_rows * In * Out)
    iters = 50 if T <= 64 else 10
    what = (
        f"bs {T}, {n_delta} of 3 adapter slots with a delta" if n_delta
        else f"one prefill chunk of {T} tokens in one delta slot"
    )
    r = dict(
        shape=f"{In}->{Out}, {what} ({n_rows} rows)",
        ms=device_ms(lambda l: delta_matmul_grouped(out, *args(l)), layers, iters),
        plain_ms=device_ms(lambda l: delta_matmul_grouped_plain(out, *args(l)), layers, 2, reps=3),
        library_ms=device_ms(lambda l: torch.bmm(xs, deq[l % n_lib]), n_lib, iters),
        bound_ms=b,
        bound_by=by,
        nbytes=nbytes,
        ops=2.0 * n_rows * In * Out,
    )
    del dq, ds, deq
    torch.cuda.empty_cache()
    return r


def phase_delta_timing() -> dict:
    """The delta kernel at each distinct projection of Llama-3.2-1B: bs 64
    with one and with three delta slots, and one 2048-token prefill chunk.
    Per forward (16 layers x 7 projections) at bs 64 with one delta slot,
    the sums of calls x time go to the ``kernels`` line."""
    rows = {}
    for name, In, Out, calls in llama_1b_projections():
        for T, n_delta in ((64, 1), (64, 3), (2048, 0)):
            r = time_delta(In, Out, T, n_delta)
            r["calls"] = calls
            rows[(name, T, n_delta)] = r
            log(
                f"[time] delta_matmul_grouped {name} {r['shape']}: {r['ms']:.4f} ms; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; "
                f"torch.bmm bf16 {r['library_ms']:.4f} ms"
            )
    per_fwd = {}
    for n_delta in (1, 3):
        dec = [r for (_, T, n), r in rows.items() if T == 64 and n == n_delta]
        tot = {f: sum(r["calls"] * r[f] for r in dec) for f in ("ms", "plain_ms", "library_ms", "nbytes", "ops")}
        per_fwd[n_delta] = dict(
            shape=f"one decode forward of Llama-3.2-1B at bs 64 (7 projections x 16 layers), "
            f"{n_delta} of 3 adapter slots with a delta",
            **{f: tot[f] for f in ("ms", "plain_ms", "library_ms")},
        )
        per_fwd[n_delta]["bound_ms"], per_fwd[n_delta]["bound_by"] = bound_ms(tot["nbytes"], tot["ops"])
        p = per_fwd[n_delta]
        log(
            f"[time] delta_matmul_grouped {p['shape']}: {p['ms']:.4f} ms; bound {p['bound_ms']:.4f} ms "
            f"({p['bound_by']}); plain {p['plain_ms']:.4f} ms; torch.bmm bf16 {p['library_ms']:.4f} ms"
        )
    return per_fwd


def time_kv_write(D: int) -> dict:
    """Host microseconds per ``write_kv`` call (the host's launch work,
    before a synchronize) and host plus device, for one decode step's K/V
    at bs 64, Hkv 8, by pool dtype: the 8-bit pools quantize each row with
    plain PyTorch ops before they scatter it."""
    import torch

    from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
    from scratchpad_tpu_torch.ops.attention import write_kv

    B, Hkv, ps, n = 64, 8, 16, 300
    gen = seeded(7000 + D)
    k = torch.randn(B, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    loc = torch.arange(B, device="cuda") * ps + ps
    r = {}
    for kind, code in (("bf16", None), ("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        pool = create_kv_cache(
            KVCacheConfig(1, B + 1, ps, Hkv, D, torch.bfloat16, quantized=code is not None,
                          quant_dtype=code or torch.int8),
            torch.device("cuda"),
        )
        for _ in range(10):
            write_kv(pool, k, v, 0, loc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            write_kv(pool, k, v, 0, loc)
        host = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        r[kind] = (host, (time.perf_counter() - t) / n * 1e6)
        log(
            f"[time] write_kv {kind} pool, B={B} Hkv={Hkv} D={D}: host {host:.1f} us per call, "
            f"host and device {r[kind][1]:.1f} us per call"
        )
    return r


def phase_timing() -> dict:
    """The first row of each kernel is its main shape in the ``kernels``
    line: Llama-3.2-1B's for the bf16 kernels, 3B's (G 3, D 128) for the
    8-bit ones, Mistral-7B's (G 4, D 128, window 4096, ctx 8192) for
    ``decode_attention_pallas``. At Mistral-7B's shape the window's rows
    time ctx 4096 and 8192 without the window beside ctx 8192 with it, and
    the 2048-token extend chunk on 4096, 5120 (as many attended pairs as
    the window's 4096 a query) and 8192 tokens beside 8192 with it."""
    t = {
        "paged_decode_attention": [
            time_decode(64, 256), time_decode(64, 4096), time_decode(64, 4096, 128, 3),
            time_decode(64, 4096, 128, 4), time_decode(64, 8192, 128, 4),
            time_decode(64, 8192, 128, 4, window=4096),
        ],
        "decode_attention_pallas": [
            time_decode(64, 8192, 128, 4, window=4096, wrapper="pallas"),
        ],
        "paged_decode_attention_quant": [
            time_decode(64, 4096, 128, 3, "int8"), time_decode(64, 4096, 128, 3, "fp8"),
            time_decode(64, 4096, 64, 4, "int8"), time_decode(64, 4096, 64, 4, "fp8"),
            time_decode(64, 256, 128, 3, "int8"),
        ],
        "paged_extend_attention": [
            time_extend([(128, 128)] * 64),
            time_extend([(2048, 8192)]),
            time_extend([(128, 128)] * 64, 128, 3),
            time_extend([(2048, 4096)], 128, 4), time_extend([(2048, 5120)], 128, 4),
            time_extend([(2048, 8192)], 128, 4), time_extend([(2048, 8192)], 128, 4, window=4096),
        ],
        "paged_extend_attention_quant": [
            time_extend([(128, 128)] * 64, 128, 3, "int8"),
            time_extend([(2048, 8192)], 128, 3, "int8"),
            time_extend([(128, 128)] * 64, 128, 3, "fp8"),
        ],
    }
    for name, rows in t.items():
        for r in rows:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms"
            )
    for D in (128, 64):
        time_kv_write(D)
    return t


def phase_profiling_tools() -> dict:
    """This slice's main path: the kernel-profiling entry point,
    ``tools/decode_ablate.py``'s ``main`` with its defaults, every launch
    count set to 0 just before and read just after. Returns its rows, the
    launch counts and the number of 16-layer chains it ran."""
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention_stage
    from scratchpad_tpu_torch.tools import decode_ablate as tool

    reset_launch_counts()
    paged_decode_attention_stage.launches = 0
    t = time.monotonic()
    rows = tool.main([])
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts["decode_stage"] = paged_decode_attention_stage.launches
    log(f"[probe] tools/decode_ablate.py main: {time.monotonic() - t:.1f} s, launches {counts}")
    modes = [r for r in rows if r["table"] == "mode"]
    stages = [r for r in rows if r["table"] == "stage"]
    check(len(modes) == 5 and counts["decode_ablate"] >= 5 * 16,
          f"the probe ran {len(modes)} modes with {counts['decode_ablate']} launches")
    check(counts["decode_stage"] > 0 and counts["paged_decode_attention"] > 0,
          f"the stage table launched the cuts {counts['decode_stage']} times and the decode kernel "
          f"{counts['paged_decode_attention']} times")
    for r in modes:
        log(
            f"[probe] {r['mode']:12s} {r['ms']:.4f} ms per {r['layers']} layers, "
            f"{r['ms_per_call']:.4f} ms a call; bound {r['bound_ms']:.4f} ms (live rows), "
            f"{r['bound_chunk_ms']:.4f} ms (chunk-padded); plain {r['plain_ms']:.4f} ms a call"
        )
    for r in stages:
        log(
            f"[stage] {r['model']} {r['shape']} stage {r['stage']} ({r['what']}): {r['ms']:.4f} ms, "
            f"{r['ms_over_bound']:.2f}x the decode's bound {r['bound_ms']:.4f} ms"
        )
    return {"rows": rows, "counts": counts}


# --------------------------------------------------------------- phase 4


def make_engine(quantization=None, preset="llama-3.2-1b", kv_cache_dtype="auto", params=None,
                model_config=None, attention_backend="auto"):
    """An engine with seeded random weights, or with ``params`` (a state
    dict of the same model, for example another engine's quantized one);
    ``model_config`` in place of the preset."""
    import torch

    from scratchpad_tpu_torch.config import ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()  # each engine's pool takes 0.85 of free memory
    t0 = time.monotonic()
    engine = Engine(
        ServerArgs(
            preset=None if model_config else preset, random_weights=True, dtype="bfloat16",
            device="cuda", quantization=quantization, kv_cache_dtype=kv_cache_dtype,
            attention_backend=attention_backend,
        ),
        model_config=model_config,
        params=params,
    )
    runner = engine.scheduler.runner
    name = model_config.architecture if model_config else preset
    log(
        f"[engine] {name} {quantization or 'bf16'}, attention_backend={attention_backend}, "
        f"kv_cache_dtype={kv_cache_dtype} -> "
        f"{runner.kv_cache_dtype} KV, ready in {time.monotonic() - t0:.1f} s "
        f"({runner.quantize_seconds:.1f} s of it quantizing on the host): "
        f"{runner.param_bytes / 2**30:.3f} GiB of parameters and buffers, "
        f"{runner.max_total_num_tokens} KV tokens ({runner.kv_bytes_per_token()} B each)"
    )
    return engine


def topping_states(cfg):
    """Two LoRA adapters (rank 16 on all seven targets of every layer;
    peft names) and one delta adapter (HF [out, in] deltas on q, v, gate and
    down of every layer), as numpy from seeds 11, 12 and 13. Each moves a
    projection's output by about a third of the base output's size: A is
    N(0, 1/In), B N(0, 0.04^2) under scaling 2.0, the delta N(0, 0.008^2)."""
    import numpy as np

    H, I, L, D = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.head_dim
    q, kv = cfg.num_attention_heads * D, cfg.num_kv_heads * D
    dims = {
        "q_proj": ("self_attn", H, q), "k_proj": ("self_attn", H, kv),
        "v_proj": ("self_attn", H, kv), "o_proj": ("self_attn", q, H),
        "gate_proj": ("mlp", H, I), "up_proj": ("mlp", H, I), "down_proj": ("mlp", I, H),
    }
    loras = []
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        st = {}
        for l in range(L):
            for t, (mod, din, dout) in dims.items():
                pre = f"base_model.model.model.layers.{l}.{mod}.{t}"
                st[f"{pre}.lora_A.weight"] = rng.standard_normal((16, din), np.float32) / np.float32(math.sqrt(din))
                st[f"{pre}.lora_B.weight"] = rng.standard_normal((dout, 16), np.float32) * np.float32(0.04)
        loras.append(st)
    rng = np.random.default_rng(13)
    delta = {
        f"model.layers.{l}.{dims[t][0]}.{t}.weight":
            rng.standard_normal((dims[t][2], dims[t][1]), np.float32) * np.float32(0.008)
        for l in range(L)
        for t in ("q_proj", "v_proj", "gate_proj", "down_proj")
    }
    return loras, delta


def register_toppings(engine, states, label: str) -> None:
    """ad1, ad2 (LoRA, scaling 2.0) and dl1 (delta) through
    ``Engine.register_topping``; logs the host seconds it takes, the pools'
    bytes on the card and the card's free memory after."""
    import torch

    loras, delta = states
    t = time.monotonic()
    engine.register_topping("ad1", state=loras[0], scaling=2.0)
    engine.register_topping("ad2", state=loras[1], scaling=2.0)
    engine.register_topping("dl1", delta_state=delta)
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    free, total = torch.cuda.mem_get_info()
    log(
        f"[engine {label}] registered ad1, ad2 (LoRA rank 16, 7 targets x "
        f"{engine.model_config.num_hidden_layers} layers, scaling 2.0) and dl1 (int8 delta on "
        f"q, v, gate, down) in {secs:.1f} s of host; topping pools "
        f"{engine.toppings_manager.device_bytes() / 2**30:.3f} GiB on the card; "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free"
    )


def batch_logits(runner, prompts, next_tokens, names=None):
    """The model's f32 logits [B, V] after one extend of ``prompts`` as one
    batch, and after one decode step of ``next_tokens`` (one a row), on
    pages borrowed from the engine's idle pool and returned after.
    ``names``: each row's adapter (None for none), or None for a batch that
    names no adapter."""
    import numpy as np

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
    from scratchpad_tpu_torch.toppings.manager import MAX_ACTIVE_TOPPINGS

    ps, B = runner.page_size, len(prompts)
    lens = [len(p) for p in prompts]
    pages = [runner.page_allocator.alloc(-(-(n + 1) // ps)) for n in lens]
    try:
        if any(p is None for p in pages):
            fail("no free pages for the logits check")
        pt = np.zeros((B, max(len(p) for p in pages)), np.int32)
        locs = []
        for i, (p, n) in enumerate(zip(pages, lens)):
            pt[i, : len(p)] = p
            pos = np.arange(n + 1)
            locs.append(p[pos // ps] * ps + pos % ps)
        extra = {}
        if names is not None:
            order = sorted({n for n in names if n})
            active = np.zeros(MAX_ACTIVE_TOPPINGS, np.int32)
            active[1 : 1 + len(order)] = [runner.toppings_manager.lookup(n) for n in order]
            slots = np.array([order.index(n) + 1 if n else 0 for n in names], np.int32)
            extra = dict(active_adapters=active, adapter_slots=slots)
        common = dict(
            page_table=pt,
            sampling_info=SamplingBatchInfo.from_reqs([], B, runner.model_config.vocab_size),
            **extra,
        )
        ext = WorkerBatch(
            mode=ForwardMode.EXTEND,
            tokens=np.concatenate([np.asarray(p) for p in prompts]),
            positions=np.concatenate([np.arange(n) for n in lens]),
            out_cache_loc=np.concatenate([l[:-1] for l in locs]),
            req_indices=np.repeat(np.arange(B), lens),
            seq_lens=np.array(lens),
            extend_lens=np.array(lens),
            **common,
        )
        dec = WorkerBatch(
            mode=ForwardMode.DECODE,
            tokens=np.asarray(next_tokens),
            positions=np.array(lens),
            out_cache_loc=np.array([l[-1] for l in locs]),
            req_indices=np.arange(B),
            seq_lens=np.array(lens) + 1,
            extend_lens=np.ones(B, np.int64),
            **common,
        )
        return runner.forward_logits(ext), runner.forward_logits(dec)
    finally:
        for p in pages:
            if p is not None:
                runner.page_allocator.free(p)


def check_toppings_logits(engine, label: str) -> float:
    """One mixed batch (two rows each of none, ad1, ad2 and dl1; 5 to 1,000
    tokens), extend and one decode step: kernel path against plain path
    with the engine's gate and argmax rule, and each adapter's rows against
    the same batch naming no adapter, which must move by at least
    ``ADAPTER_MOVE`` times the worst kernel-vs-plain reading. Returns that
    reading."""
    import numpy as np
    import torch

    runner = engine.scheduler.runner
    V = runner.model_config.vocab_size
    rng = np.random.default_rng(5)
    names = [None, "ad1", "ad2", "dl1"] * 2
    prompts = [rng.integers(1, V, n).tolist() for n in (5, 37, 128, 300, 511, 64, 200, 1000)]
    firsts = [p[0] for p in prompts]
    kern = batch_logits(runner, prompts, firsts, names)
    with PlainPath(runner.model):
        plain = batch_logits(runner, prompts, firsts, names)
    base = batch_logits(runner, prompts, firsts)
    tol, worst = LOGIT_RTOL[label], 0.0
    for step in (0, 1):
        for i, name in enumerate(names):
            a, b = kern[step][i], plain[step][i]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst = max(worst, rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            tie = gap <= max(
                math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8), ARGMAX_FLOOR[label] * scale
            )
            same = bool(a.argmax() == b.argmax())
            check(rel <= tol, f"{label}: row {i} ({name}) step {step}: kernel-path logits differ by {rel:.3e}")
            check(same or tie, f"{label}: row {i} ({name}) step {step}: argmax differs outside a tie")
            if not same:
                log(
                    f"[engine {label}] mixed row {i} ({name}) step {step}: argmax {int(a.argmax())} vs "
                    f"{int(b.argmax())}; plain top-2 gap {gap / scale:.3e} of max|logit| (tie {tie})"
                )
    moves = {}
    for step in (0, 1):
        for i, name in enumerate(names):
            d = float((kern[step][i] - base[step][i]).abs().max()) / float(base[step][i].abs().max())
            moves.setdefault(name, []).append(d)
    log(
        f"[engine {label}] mixed batch of {len(names)} rows, extend and decode: kernel vs plain "
        f"worst max|diff|/max|logit| {worst:.3e} (tol {tol}); move against no adapter, min over "
        f"rows: "
        + ", ".join(f"{n or 'none'} {min(m):.3e}" for n, m in moves.items())
        + f" (none rows: max {max(moves[None]):.3e})"
    )
    for name in ("ad1", "ad2", "dl1"):
        check(
            min(moves[name]) >= ADAPTER_MOVE * worst,
            f"{label}: {name} moves its rows' logits by {min(moves[name]):.3e}, under "
            f"{ADAPTER_MOVE} x the kernel-vs-plain reading {worst:.3e}",
        )
    return worst


def set_w4_route(model, a8: bool) -> None:
    from scratchpad_tpu_torch.models.common import QuantLinear

    for m in model.modules():
        if isinstance(m, QuantLinear):
            m.a8 = a8


class PlainPath:
    """Within the block, the model runs every kernel's plain version: the
    attention functions it holds, the W4 functions ``QuantLinear`` calls
    (module globals of ``models.common``) and the delta function
    ``apply_topping`` calls (a module global of ``toppings.manager``)."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        from scratchpad_tpu_torch.models import common
        from scratchpad_tpu_torch.ops.attention import decode_attention_plain, extend_attention_plain
        from scratchpad_tpu_torch.ops import ldmm
        from scratchpad_tpu_torch.ops.quant import w4_matmul
        from scratchpad_tpu_torch.toppings import manager

        self.saved_delta = manager.delta_matmul_grouped
        manager.delta_matmul_grouped = ldmm.delta_matmul_grouped_plain
        self.saved_attn = (self.model.decode_attention, self.model.extend_attention)
        self.saved_w4 = (common.quantize_rows_int8, common.w4a8_matmul, common.w4a16_matmul)
        self.model.decode_attention, self.model.extend_attention = (
            decode_attention_plain, extend_attention_plain,
        )
        common.quantize_rows_int8 = w4_matmul.quantize_activations_plain
        common.w4a8_matmul = w4_matmul.w4a8_matmul_plain
        common.w4a16_matmul = w4_matmul.w4a16_matmul_plain

    def __exit__(self, *exc):
        from scratchpad_tpu_torch.models import common
        from scratchpad_tpu_torch.toppings import manager

        manager.delta_matmul_grouped = self.saved_delta
        self.model.decode_attention, self.model.extend_attention = self.saved_attn
        common.quantize_rows_int8, common.w4a8_matmul, common.w4a16_matmul = self.saved_w4


def weights_fingerprint(model) -> list[float]:
    """f32 sums of the embedding, the first and last layers' first
    projection and the head: equal for two draws from one seed."""
    return [
        float(t.float().sum())
        for t in (model.embed.weight, model.layers[0].wq.weight, model.layers[-1].down.weight,
                  model.lm_head.weight)
    ]


class NoWindow:
    """Within the block, the model attends without its sliding window."""

    def __init__(self, model):
        self.cfg = model.cfg

    def __enter__(self):
        self.saved, self.cfg.sliding_window = self.cfg.sliding_window, None

    def __exit__(self, *exc):
        self.cfg.sliding_window = self.saved


# (prompt tokens, new tokens) of the request set, before the two prompts
# that share a 600-token prefix (32 new tokens each); "chunk" is
# chunked_prefill_size
REQUESTS = [(5, 32), (37, 32), (128, 32), (300, 32), (511, 32), ("chunk+952", 32)]
# Mistral-7B's, window 4096: a prompt of three 2048-token chunks, the last
# two past the window, and one whose 16 decode steps cross the window's edge
WINDOW_REQUESTS = [(5, 32), (37, 32), (300, 32), (6000, 32), (4090, 16)]


def phase_engine(engine, label: str, w4_kernels=(), logits=True, toppings=None,
                 requests=REQUESTS) -> dict:
    """Serve the request set through ``Engine.generate`` with every launch
    count set to 0 just before and read just after; check each request,
    the radix hit, the launches of both attention kernels of the pool's
    kind (one per layer and forward of their mode; the other kind's never),
    of ``decode_attention_pallas`` (every decode launch under
    ``attention_backend="pallas"``, none under ``auto``) and of
    ``w4_kernels`` (one per quantized matrix and forward: 6 per layer and
    the head), and, with ``logits``, the kernel-path logits against the
    plain path's. The argmax must agree on every row
    but a bf16 tie: the plain path's top-2 logits equal or one bf16 ulp
    apart. Each row whose argmax differs is logged with its gap. A model
    with a sliding window must move the logits of each prompt longer than
    the window by at least ``WINDOW_MOVE`` times the worst reading against
    the plain path without it.
    ``toppings``: each request's adapter (see ``TOPPINGS``); the delta
    kernel must then launch once per projection and layer of every forward
    whose batch names an adapter, and never without ``toppings``, and the
    logits are those of ``check_toppings_logits``."""
    import numpy as np
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    runner = engine.scheduler.runner
    cfg = runner.model_config
    L = cfg.num_hidden_layers
    model = runner.model
    forwards = {ForwardMode.EXTEND: 0, ForwardMode.DECODE: 0}
    topped = [0]  # forwards whose batch names an adapter
    inner_forward = model.forward  # the timer below wraps counting_forward

    def counting_forward(meta, kv):
        forwards[meta.mode] += 1
        topped[0] += meta.active_adapters is not None
        return inner_forward(meta, kv)

    model.forward = counting_forward

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    shared = rng.integers(1, V, 600).tolist()
    chunk = engine.args.chunked_prefill_size
    lens = [chunk + 952 if n == "chunk+952" else n for n, _ in requests]
    prompts = [rng.integers(1, V, n).tolist() for n in lens] + [shared + rng.integers(1, V, 40).tolist()]
    second = [shared + rng.integers(1, V, 25).tolist()]  # radix hit on `shared`
    new_tokens = [m for _, m in requests] + [32, 32]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True) for m in new_tokens]
    tops = toppings or [None] * (len(prompts) + 1)

    engine.flush_cache()
    reset_launch_counts()
    with PrefillTimer(model) as prefill:
        outs = engine.generate(input_ids=prompts, sampling_params=sps[:-1], topping=tops[:-1])
        outs += engine.generate(input_ids=second, sampling_params=sps[-1:], topping=tops[-1])
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    torch.cuda.synchronize()
    model.forward = inner_forward
    log(
        f"[prefill {label}] requests of {[len(p) for p in prompts + second]} tokens: "
        f"{prefill.forwards} extend forwards, device {prefill.device_ms:.3f} ms, "
        f"wall {prefill.wall_ms:.3f} ms"
    )
    n_ext, n_dec = forwards[ForwardMode.EXTEND], forwards[ForwardMode.DECODE]
    log(
        f"[engine {label}] {len(outs)} requests: {n_ext} extend and {n_dec} decode forwards; "
        f"kernel launches {counts}"
    )
    for o, p, m in zip(outs, prompts + second, new_tokens):
        check(
            o.completion_tokens == m and len(o.output_ids) == m and o.finish_reason == "length",
            f"{label} request {o.rid}: {o.completion_tokens} tokens, finish {o.finish_reason}",
        )
        check(o.prompt_tokens == len(p), f"{label} request {o.rid}: prompt_tokens {o.prompt_tokens} != {len(p)}")
    if tops[-1] == tops[-2]:
        check(outs[-1].cached_tokens >= 512, f"{label}: no radix hit: cached_tokens {outs[-1].cached_tokens}")
    else:  # the shared prefix's KV was computed under another adapter
        check(outs[-1].cached_tokens == 0, f"{label}: KV reused across adapters: {outs[-1].cached_tokens}")
    log(
        f"[engine {label}] shared 600-token prefix under adapters {tops[-2]} and {tops[-1]}: "
        f"{outs[-1].cached_tokens} cached tokens; prompts of {lens} tokens (chunks of {chunk})"
    )
    pages = runner.kv_cache_dtype if runner.kv_cache.quantized else "bf16"
    need = {EXTEND[pages]: L * n_ext, DECODE[pages]: L * n_dec}
    for k in w4_kernels:
        need[k] = (6 * L + 1) * (n_ext + n_dec)
    for k, n in need.items():
        check(counts[k] >= n > 0, f"{label}: {k} launched {counts[k]} times, fewer than {n}")
    # one delta launch per projection and layer of each forward with adapters
    n_top = 7 * L * topped[0]
    check(
        counts["delta_matmul_grouped"] == n_top and (n_top > 0) == (toppings is not None),
        f"{label}: delta_matmul_grouped launched {counts['delta_matmul_grouped']} times, not "
        f"{n_top} ({topped[0]} forwards with adapters)",
    )
    other = "bf16" if runner.kv_cache.quantized else "int8"
    for k in (EXTEND[other], DECODE[other]):
        check(counts[k] == 0, f"{label}: {k} launched {counts[k]} times on a {pages} pool")
    # every decode launch goes through decode_attention_pallas under
    # attention_backend="pallas", and none under auto
    pallas = runner.attention_backend == "pallas"
    check(
        counts["decode_attention_pallas"] == (counts[DECODE[pages]] if pallas else 0),
        f"{label} ({runner.attention_backend}): decode_attention_pallas launched "
        f"{counts['decode_attention_pallas']} times against {counts[DECODE[pages]]} decode launches",
    )
    steps = {
        EXTEND[pages]: n_ext, DECODE[pages]: n_dec,
        **{k: n_ext + n_dec for k in w4_kernels},
        "delta_matmul_grouped": topped[0],
        "decode_attention_pallas": n_dec if pallas else 0,
    }

    result = dict(
        counts=counts, steps=steps, worst_logit_rel=None,
        preset=engine.args.preset or cfg.architecture, weights=engine.args.quantization or "bf16",
        kv_cache_dtype=runner.kv_cache_dtype, attention_backend=runner.attention_backend,
        output_ids=[o.output_ids for o in outs],
    )
    if not logits:
        return result
    if toppings:
        result["worst_logit_rel"] = check_toppings_logits(engine, label)
        return result
    # kernel path vs plain path logits for each prompt's first generated
    # token (extend) and the step after it (decode), on the card
    tol = LOGIT_RTOL[label]
    worst = {0: 0.0, 1: 0.0}  # by step: 0 = extend, 1 = decode
    agree = ties = 0
    min_margin = math.inf  # the plain path's top-2 gap over max |logit|
    window = cfg.sliding_window
    moves = []  # (prompt length, step, kernel path against the plain path without the window)
    for p, o in zip(prompts + second, outs):
        kern = batch_logits(runner, [p], [o.output_ids[0]])
        with PlainPath(model):
            plain = batch_logits(runner, [p], [o.output_ids[0]])
            if window is not None and len(p) > window:
                with NoWindow(model):
                    unwindowed = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    a, b = kern[step][0], unwindowed[step][0]
                    moves.append((len(p), step, float((a - b).abs().max()) / float(b.abs().max())))
        for step in (0, 1):
            a, b = kern[step][0], plain[step][0]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst[step] = max(worst[step], rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            min_margin = min(min_margin, gap / scale)
            # the logits are bf16: a tie is a top-2 gap of at most one bf16
            # ulp of the top logit (equal or adjacent bf16 values); W4A8
            # also excuses gaps under its sound route's floor
            tie = gap <= max(
                math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8), ARGMAX_FLOOR[label] * scale
            )
            ties += int(tie)
            same = bool(a.argmax() == b.argmax())
            agree += int(same)
            check(rel <= tol, f"{label}: kernel-path logits differ from the plain path by {rel:.3e} of max |logit|")
            if not same:
                log(
                    f"[engine {label}] request {o.rid} step {step}: argmax {int(a.argmax())} "
                    f"(kernel) vs {int(b.argmax())} (plain); plain top-2 {float(top2[0]):.6g}, "
                    f"{float(top2[1]):.6g} (gap {gap / scale:.3e} of max|logit|, tie {tie}); "
                    f"max|diff| {rel:.3e} of max|logit|"
                )
            check(same or tie, f"{label} request {o.rid} step {step}: argmax differs outside a bf16 tie")
    log(
        f"[engine {label}] kernel vs plain logits over {2 * len(outs)} rows: worst "
        f"max|diff|/max|logit| {worst[0]:.3e} after the extend, {worst[1]:.3e} after "
        f"the decode step (tol {tol}); argmax agrees on {agree} of {2 * len(outs)}, "
        f"{ties} rows with a bf16 tie at the top; smallest plain top-2 gap "
        f"{min_margin:.3e} of max|logit|"
    )
    result["worst_logit_rel"] = max(worst.values())
    if window is not None:
        reading = max(worst.values())
        log(
            f"[engine {label}] window {window}: kernel path against the plain path without the "
            f"window, prompt and step: "
            + ", ".join(f"{n} tokens step {st} {m:.3e}" for n, st, m in moves)
            + f" (at least {WINDOW_MOVE} x {reading:.3e})"
        )
        check(bool(moves), f"{label}: no prompt longer than the window {window}")
        for n, st, m in moves:
            check(
                m >= WINDOW_MOVE * reading,
                f"{label}: the window moves the {n}-token prompt's logits (step {st}) by only "
                f"{m:.3e}, under {WINDOW_MOVE} x the kernel-vs-plain reading {reading:.3e}",
            )
    return result


PROFILED_WINDOWS = (2, 5)  # decode windows [2, 5) of the profiled run


def phase_engine_times(engine, eng: dict, label: str, toppings: bool = False) -> None:
    """Decode tokens/s at the bench shape (bs 64, 128 + 128; with
    ``toppings``, the requests name none, ad1, ad2 and dl1 in turn), and the
    device's busy share of a decode step: the device time per step over
    decode windows ``PROFILED_WINDOWS`` of a profiled run (all 64 rows
    decoding; a trace of the whole run took ``key_averages`` about a minute
    per engine to digest) against the wall per step of the timed run. The
    profiler slows the host several times over, so the profiled window's
    own wall is logged but not used."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
    from scratchpad_tpu_torch.tools import analyze_trace

    runner = engine.scheduler.runner
    dec_time = [0.0]
    dec_tokens = [0]
    inner_window = runner.run_decode_window

    def timed_window(wb, K):
        t = time.perf_counter()
        out = inner_window(wb, K)  # ends in a host fetch of the sampled ids
        dec_time[0] += time.perf_counter() - t
        dec_tokens[0] += out[0].shape[0] * out[0].shape[1]
        return out

    runner.run_decode_window = timed_window
    rng = np.random.default_rng(1)
    bench = [rng.integers(1, runner.model_config.vocab_size, 128).tolist() for _ in range(64)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    tops = [None, "ad1", "ad2", "dl1"] * 16 if toppings else None

    def run():
        engine.flush_cache()
        dec_time[0], dec_tokens[0] = 0.0, 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = engine.generate(input_ids=bench, sampling_params=[sp] * 64, topping=tops)
        wall = time.perf_counter() - t
        if any(len(r.output_ids) != 128 for r in res):
            fail("bench requests did not finish with 128 tokens")
        return dec_tokens[0] / dec_time[0], 64 * 128 / wall, wall

    # the warm-up run (it warms the caching allocator and cuBLAS) times its
    # extend forwards; the timed runs below carry no timer
    with PrefillTimer(runner.model) as prefill:
        run()
    log(
        f"[prefill {label}] bs 64 x 128-token prompts: {prefill.forwards} extend forwards, "
        f"device {prefill.device_ms:.3f} ms, wall {prefill.wall_ms:.3f} ms"
    )
    eng["decode_tok_s"], eng["e2e_tok_s"], _ = run()
    log(
        f"[engine {label}] bs 64, 128+128: decode {eng['decode_tok_s']:.1f} tok/s "
        f"(time inside decode windows), {eng['e2e_tok_s']:.1f} tok/s end to end"
    )
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    span = {"windows": 0, "steps": 0}

    def profiled_window(wb, K):
        n = span["windows"]
        if n == PROFILED_WINDOWS[0]:
            torch.cuda.synchronize()
            prof.start()
            span["t0"] = time.perf_counter()
        out = timed_window(wb, K)
        if PROFILED_WINDOWS[0] <= n < PROFILED_WINDOWS[1]:
            span["steps"] += out[0].shape[0]
        if n == PROFILED_WINDOWS[1] - 1:
            torch.cuda.synchronize()
            span["wall"] = time.perf_counter() - span["t0"]
            prof.stop()
        span["windows"] = n + 1
        return out

    runner.run_decode_window = profiled_window
    run()
    runner.run_decode_window = inner_window
    if "wall" not in span:
        fail(f"{label}: the bench run had {span['windows']} decode windows, too few to profile")
    wall = span["wall"]
    # device-side events only (kernels, copies, memsets): a CPU op's row
    # repeats the device time of the kernels it launched
    rows = [
        (e.key, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    busy_us = sum(t for _, t in rows)
    if busy_us > 0:
        step_ms = 64 / eng["decode_tok_s"] * 1e3  # the timed run's wall per decode step
        eng["device_ms_per_step"] = busy_us / 1e3 / span["steps"]
        eng["device_busy_share"] = eng["device_ms_per_step"] / step_ms
        log(
            f"[profile {label}] bs 64, 128+128 run, decode windows {PROFILED_WINDOWS[0]} to "
            f"{PROFILED_WINDOWS[1] - 1} ({span['steps']} steps): device busy "
            f"{busy_us / 1e3:.1f} ms, {eng['device_ms_per_step']:.3f} ms per step, against "
            f"{step_ms:.3f} ms of wall per step in the timed run: busy share "
            f"{eng['device_busy_share']:.3f} (the profiled window's own wall {wall * 1e3:.1f} ms)"
        )
        for key, t in sorted(rows, key=lambda r: -r[1])[:12]:
            log(f"[profile {label}]   {t / 1e3:9.2f} ms  {key[:100]}")
        # the same windows' trace, by category (tools/analyze_trace.py)
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            r = analyze_trace.rollup(analyze_trace.load_events(path))
        eng["trace_by_category_ms"] = {c: us / 1e3 for c, us in r["by_category"].items()}
        for line in analyze_trace.report(r, top=5):
            log(f"[profile {label}] {line}")
    else:
        eng["device_busy_share"] = eng["device_ms_per_step"] = None
        log(f"[profile {label}] the profiler recorded no device time: busy share not measured")


# ------------------------------------------------------------------ main


KERNELS = {
    "paged_decode_attention": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel) "
        "and :446 (_gqa_decode_grouped_kernel)",
    ),
    "paged_extend_attention": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 "
        "(bundled ragged_paged_attention via _ragged_call)",
    ),
    "paged_decode_attention_quant": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel, "
        "quantized branch :371-405) and :446 (_gqa_decode_grouped_kernel, quantized "
        "branch :606-642)",
    ),
    "paged_extend_attention_quant": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled "
        "ragged_paged_attention via _ragged_call) on the pages of dequant_pages :175 "
        "(attention_ragged_quant :254)",
    ),
    "quantize_rows_int8": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:452-461 (the int8 activation "
        "quantization of _w4_q4_call, outside the Pallas kernel)",
    ),
    "w4a8_matmul": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:363 (_w4a8_kernel_q4) "
        "and :139 (_w4a8_kernel)",
    ),
    "w4a16_matmul": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a16_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:394 (_w4_kernel_q4) "
        "and :27 (_w4_kernel)",
    ),
    "delta_matmul_grouped": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/delta_matmul.cu",
        replaces="scratchpad_tpu/ops/ldmm.py:51 (_delta_kernel, launched :121 by delta_matmul :72)",
    ),
    # the decode kernel of row 1, through its own wrapper (with its own count)
    "decode_attention_pallas": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/pallas_decode.py:34 (_decode_kernel, launched :177)",
    ),
    "decode_ablate": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/decode_ablate.cu",
        replaces="tools/profiling/_ablate.py:11 (make_kernel, launched :106)",
    ),
}
# the engine run whose launches each kernel's entry reports
KERNEL_ENGINE = {
    "paged_decode_attention": "bf16", "paged_extend_attention": "bf16",
    "paged_decode_attention_quant": "3b-w4a8", "paged_extend_attention_quant": "3b-w4a8",
    "quantize_rows_int8": "w4a8", "w4a8_matmul": "w4a8", "w4a16_matmul": "w4a16",
    "delta_matmul_grouped": "1b-toppings", "decode_attention_pallas": "mistral-7b-pallas",
}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not (ROOT / "scratchpad_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no scratchpad_tpu_torch/)")
    sys.path.insert(0, str(ROOT))
    t0 = time.monotonic()
    name, smi_line = phase_device()
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    check_decode(errs)
    check_extend(errs)
    check_window_decode(errs)
    check_window_extend(errs)
    check_pallas_decode(errs)
    check_kv_quantizer()
    check_w4(errs)
    check_delta(errs)
    check_decode_ablate(errs)
    check_decode_stages()
    # the timed runs follow each engine's checks, and only while every
    # check holds: a faulty tree shows all its readings, quickly
    engines = {}
    w4a8 = ("quantize_rows_int8", "w4a8_matmul")

    def serve(engine, label, w4_kernels=(), logits=True, toppings=None, timed=True,
              requests=REQUESTS):
        t = time.monotonic()
        engines[label] = phase_engine(engine, label, w4_kernels, logits, toppings, requests)
        t_times = time.monotonic()
        if timed and not FAILURES:
            phase_engine_times(engine, engines[label], label, toppings is not None)
        log(
            f"[engine {label}] phase wall: {t_times - t:.1f} s serving and checking, "
            f"{time.monotonic() - t_times:.1f} s timing"
        )

    engine = make_engine()
    serve(engine, "bf16")
    # toppings on the same engine and weights, so that the two rates are
    # taken in one call
    states = topping_states(engine.model_config)
    register_toppings(engine, states, "1b-toppings")
    serve(engine, "1b-toppings", toppings=TOPPINGS)
    del engine  # frees the pool and the weights for the next engine
    engine = make_engine("w4a8")
    serve(engine, "w4a8", w4a8)
    # W4A16 on the same engine and codes: every QuantLinear takes the A16 route
    set_w4_route(engine.scheduler.runner.model, a8=False)
    serve(engine, "w4a16", ("w4a16_matmul",))
    engines["w4a16"]["weights"] = "w4a16"
    # the same toppings on W4A8: the fused gate|up split on the card
    set_w4_route(engine.scheduler.runner.model, a8=True)
    register_toppings(engine, states, "w4a8-toppings")
    del states
    serve(engine, "w4a8-toppings", w4a8, toppings=TOPPINGS, timed=False)
    del engine
    # Llama-3.2-3B W4A8: kv_cache_dtype=auto must give int8 KV, as the JAX
    # runner's rule does at hidden x layers = 86,016
    engine = make_engine("w4a8", preset="llama-3.2-3b")
    check(
        engine.scheduler.runner.kv_cache_dtype == "int8",
        f"3B W4A8 auto KV resolved to {engine.scheduler.runner.kv_cache_dtype}, not int8",
    )
    serve(engine, "3b-w4a8", w4a8)
    # the same quantized weights with bf16 KV: the auto rule's premise
    params = dict(engine.scheduler.runner.model.state_dict())
    del engine
    engine = make_engine("w4a8", preset="llama-3.2-3b", kv_cache_dtype="bfloat16", params=params)
    del params
    # (its kernels are held elsewhere: bf16 attention at G = 3 in phase 3
    # and in the bf16 engine, W4A8 in both W4A8 engines; it is here for
    # its launch counts and its times, so its logits are not checked)
    serve(engine, "3b-w4a8-bf16kv", w4a8, logits=False)
    del engine
    engine = make_engine(kv_cache_dtype="fp8")
    serve(engine, "1b-fp8kv")
    del engine
    # Mistral-7B at full width and depth, its window through the decode and
    # extend kernels: attention_backend auto, then pallas on the same
    # weights (drawn again from the same seed)
    from scratchpad_tpu_torch.config import ModelConfig

    fingerprints = []
    for label, backend in (("mistral-7b", "auto"), ("mistral-7b-pallas", "pallas")):
        engine = make_engine(
            model_config=ModelConfig.from_hf_config(MISTRAL_7B), attention_backend=backend
        )
        fingerprints.append(weights_fingerprint(engine.scheduler.runner.model))
        serve(engine, label, requests=WINDOW_REQUESTS, timed=backend == "auto")
        del engine
    check(fingerprints[0] == fingerprints[1], f"the Mistral engines' weights differ: {fingerprints}")
    same = sum(
        a == b for a, b in zip(engines["mistral-7b"]["output_ids"], engines["mistral-7b-pallas"]["output_ids"])
    )
    log(
        f"[engine mistral-7b-pallas] greedy tokens equal to mistral-7b's on {same} of "
        f"{len(engines['mistral-7b']['output_ids'])} requests (the same kernels on the same weights)"
    )
    gc.collect()
    torch.cuda.empty_cache()
    if FAILURES:
        fail(f"{len(FAILURES)} correctness checks failed; the first: {FAILURES[0]}")
    timing = phase_timing()
    timing.update({k: [v] for k, v in phase_w4_timing()["per_forward"].items()})
    delta = phase_delta_timing()
    timing["delta_matmul_grouped"] = [delta[1], delta[3]]
    probe = phase_profiling_tools()
    if FAILURES:
        fail(f"{len(FAILURES)} correctness checks failed; the first: {FAILURES[0]}")
    full = next(r for r in probe["rows"] if r.get("mode") == "full")
    timing["decode_ablate"] = [dict(
        ms=full["ms_per_call"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
        bound_by=full["bound_by"], library_ms=None,  # no one PyTorch call computes the statistic
        shape="full mode, " + full["shape"],
    )]
    kernels = []
    for kname, meta in KERNELS.items():
        main_shape = timing[kname][0]  # the other rows are in the [time] lines
        if kname == "decode_ablate":  # on no serving path: the probe's run
            counts, per_forward = probe["counts"], None
        else:
            eng = engines[KERNEL_ENGINE[kname]]
            counts = eng["counts"]
            per_forward = eng["counts"][kname] / max(eng["steps"][kname], 1)
        kernels.append(
            dict(
                name=kname,
                **meta,
                launches=counts[kname],
                launches_per_forward=per_forward,
                max_abs_err=errs[kname],
                ms=main_shape["ms"],
                plain_ms=main_shape["plain_ms"],
                bound_ms=main_shape["bound_ms"],
                bound_by=main_shape["bound_by"],
                library_ms=main_shape["library_ms"],
                shape=main_shape["shape"],
            )
        )
    log(f"[done] {time.monotonic() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    fields = (
        "preset", "weights", "kv_cache_dtype", "attention_backend", "decode_tok_s", "e2e_tok_s",
        "device_busy_share", "device_ms_per_step", "worst_logit_rel",
    )
    log(
        json.dumps(
            {
                "engines": {
                    label: {
                        "shape": "bs 64, 128 prompt + 128 new tokens",
                        **{k: e.get(k) for k in fields},  # untimed: null
                    }
                    for label, e in engines.items()
                }
            }
        )
    )
    log(smi_line)
    log(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
            }
        )
    )


if __name__ == "__main__":
    main()
