#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scratchpad_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device is a failure.
2. build: compiles every CUDA kernel of the port from ``scratchpad_tpu_torch/
   csrc`` with ``nvcc`` for sm_90a, one ``nvcc`` per source, in parallel.
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   same bf16 inputs (the plain version computes and returns f32), at decode
   shapes of short (256) and long (4096) contexts, batch 1 and 64, head_dim
   64 and 128, with ``seq_len == 0`` rows; and at extend shapes with mixed
   chunk lengths, cached prefixes and padded tokens. Tolerance: |kernel -
   plain| <= ATOL + RTOL * |plain| elementwise (see below); padded rows
   must be exact zeros.
4. engine: ``Engine.generate`` on Llama-3.2-1B at full width in bf16 with
   random weights: greedy requests of different lengths, two that share a
   long prefix (radix hit), one longer than ``chunked_prefill_size``.
   Every kernel's launch count is set to 0 just before and read just
   after; each must be at least layers x forwards of its mode. The
   model's logits on the kernel path are held against the plain path
   for each prompt's first generated token and one decode step after it:
   the argmax must agree on every row, and max |diff| must stay within
   LOGIT_RTOL of max |logit|.
   Phases 3 and 4 record a failed check and go on, so that a faulty
   kernel still shows every reading; the script exits non-zero after
   phase 4 if any check failed.
5. times: the engine's decode tokens/s at batch 64 with 128-token prompts
   and 128 new tokens, and the device's busy share over such a run
   (``torch.profiler``). Then, with the engine freed, each kernel's median
   device time at the main path's shapes, beside its bound (bytes at 3.35
   TB/s or operations at 989 TFLOP/s, whichever is larger), its plain
   version's time and one PyTorch library call that computes the same
   function (``scaled_dot_product_attention`` on gathered dense K/V; a
   yardstick only, the port never calls it).
6. one JSON line with every kernel's numbers, one with the engine's, the
   ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
   {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM, dense
# Kernel vs plain version. Both kernels accumulate in f32 and round only
# their output to bf16, which moves a value by at most 2**-8 of itself;
# ATOL covers the order of the f32 sums. A kernel that drops one page of a
# 4096-token context misses this by far (PERF.md, Findings).
ATOL, RTOL = 1e-4, 2.0**-8
# Kernel-path vs plain-path logits, relative to the largest |logit|: each
# path rounds its attention output to bf16 on its own, and the difference
# grows through 16 layers of random weights. Sound kernels read up to
# 1.585e-2; a decode kernel that drops its last page reads 5.2e-2 to 0.38,
# one that drops a page of the prefill 0.37 to 0.73 (PERF.md, Findings).
LOGIT_RTOL = 3e-2
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


def max_err(out, ref) -> tuple[float, float]:
    """max |out - ref| and the largest ratio of |out - ref| to its
    tolerance (<= 1 passes); ``ref`` is the plain version's f32 output."""
    d = (out.float() - ref).abs()
    ratio = d / (ATOL + RTOL * ref.abs())
    return float(d.max()), float(ratio.max())


def device_ms(fn, n_layers: int, iters: int, reps: int = 5) -> float:
    """Median device milliseconds per call. A sleep kernel holds the stream
    while the host enqueues ``iters`` calls, so the events time the device
    work back to back and not the host's launch rate. Calls cycle over
    ``n_layers`` buffers so that, as on the main path, the data does not
    stay in the 50 MB L2 cache between calls."""
    import torch

    for i in range(3):
        fn(i % n_layers)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
        start.record()
        for i in range(iters):
            fn(i % n_layers)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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


def phase_build():
    from scratchpad_tpu_torch.utils import native

    t0 = time.monotonic()
    report = native.build()
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {time.monotonic() - t0:.1f} s")


# --------------------------------------------------------------- phase 3


def check_decode(errs: dict) -> None:
    import torch

    from scratchpad_tpu_torch.ops.attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    Hkv, G, ps = 8, 4, 16
    seed = 0
    for D in (64, 128):
        for B in (1, 64):
            for ctx in (256, 4096):
                seed += 1
                gen = seeded(seed)
                lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
                lens[0] = ctx
                lens = lens.to(torch.int32)
                k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
                q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
                scale = 1.0 / math.sqrt(D)
                out = paged_decode_attention(q, k[0], v[0], pt, lens, scale)
                ref = paged_decode_attention_plain(q.float(), k[0], v[0], pt, lens, scale)
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                errs["paged_decode_attention"] = max(errs["paged_decode_attention"], e)
                log(
                    f"[check] decode D={D} B={B} ctx={ctx}: max_abs_err {e:.3e}, "
                    f"max err/tol {ratio:.3f} (tol {ATOL}+{RTOL}*|ref|)"
                )
                check(ratio <= 1, f"decode kernel disagrees with its plain version at D={D} B={B} ctx={ctx}")
        # padding rows: seq_len == 0 must give exact zeros
        gen = seeded(100 + D)
        lens = torch.tensor([300, 0, 17, 0], dtype=torch.int32, device="cuda")
        k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
        q = torch.randn(4, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
        out = paged_decode_attention(q, k[0], v[0], pt, lens, 0.125)
        ref = paged_decode_attention_plain(q.float(), k[0], v[0], pt, lens, 0.125)
        torch.cuda.synchronize()
        e, ratio = max_err(out, ref)
        zero = bool((out[1] == 0).all() and (out[3] == 0).all())
        log(
            f"[check] decode D={D} padding rows: max_abs_err {e:.3e}, max err/tol "
            f"{ratio:.3f}, zero rows exact: {zero}"
        )
        check(ratio <= 1 and zero, f"decode kernel padding rows wrong at D={D}")


def extend_case(chunks, D, T_pad, seed):
    """chunks: (q_len, kv_len) per sequence; tokens past the chunks up to
    T_pad are padding."""
    import torch

    gen = seeded(seed)
    Hkv, G, ps = 8, 4, 16
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

    from scratchpad_tpu_torch.ops.attention import (
        paged_extend_attention,
        paged_extend_attention_plain,
    )

    cases = [
        # fresh prompt, chunk after a cached prefix, short tail, decode-like row
        ([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048),
        # a chunked prefill's second chunk next to fresh prompts, T = 4096
        ([(2048, 4096), (1500, 1500), (300, 845), (200, 200)], 4096),
    ]
    seed = 200
    for D in (64, 128):
        for chunks, T_pad in cases:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, D, T_pad, seed)
            scale = 1.0 / math.sqrt(D)
            out = paged_extend_attention(q, k, v, pt, kv_lens, cu, scale)
            ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale)
            torch.cuda.synchronize()
            e, ratio = max_err(out, ref)
            n_real = int(cu[-1])
            zero = bool((out[n_real:] == 0).all())
            errs["paged_extend_attention"] = max(errs["paged_extend_attention"], e)
            log(
                f"[check] extend D={D} chunks={chunks} T={q.shape[0]}: max_abs_err "
                f"{e:.3e}, max err/tol {ratio:.3f}, {q.shape[0] - n_real} padded "
                f"tokens zero: {zero}"
            )
            check(
                ratio <= 1 and zero,
                f"extend kernel disagrees with its plain version at D={D} chunks={chunks}",
            )


# --------------------------------------------------------- phase 5 (kernels)


def time_decode(B: int, ctx: int, D: int = 64) -> dict:
    """The 1B decode shape: Hq 32, Hkv 8, head_dim 64, page 16."""
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.ops.attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    Hkv, G, ps = 8, 4, 16
    per_layer = B * ctx * Hkv * D * 2 * 2
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(1000 + B + ctx)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, layers, gen)
    q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    kern = lambda l: paged_decode_attention(q, k[l], v[l], pt, lens, scale)
    plain = lambda l: paged_decode_attention_plain(q, k[l], v[l], pt, lens, scale)
    # dense [B, Hkv, S, D] copies for the library call, gathered once
    slots = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(B, -1)[:, :ctx]
    kd = [k[l].reshape(-1, Hkv, D)[slots].transpose(1, 2).contiguous() for l in range(layers)]
    vd = [v[l].reshape(-1, Hkv, D)[slots].transpose(1, 2).contiguous() for l in range(layers)]
    q4 = q.view(B, Hkv * G, 1, D)
    lib = lambda l: F.scaled_dot_product_attention(q4, kd[l], vd[l], scale=scale, enable_gqa=True)
    nbytes = q.numel() * 2 * 2 + B * ctx * Hkv * D * 2 * 2 + pt.numel() * 4 + B * 4
    flops = 4.0 * B * ctx * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"B={B} ctx={ctx} Hq={Hkv * G} Hkv={Hkv} D={D} page={ps}",
        ms=device_ms(kern, layers, 50),
        plain_ms=device_ms(plain, layers, 5),
        library_ms=device_ms(lib, layers, 50),
        bound_ms=b,
        bound_by=by,
    )
    del kd, vd, k, v
    torch.cuda.empty_cache()
    return r


def time_extend(chunks, D: int = 64) -> dict:
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.ops.attention import (
        paged_extend_attention,
        paged_extend_attention_plain,
    )

    Hkv, G, ps = 8, 4, 16
    kv_total = sum(c[1] for c in chunks)
    per_layer = kv_total * Hkv * D * 2 * 2
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(2000 + len(chunks))
    q_lens = [c[0] for c in chunks]
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0).to(torch.int32)
    T = sum(q_lens)
    k, v, pt = make_pool(kv_lens.tolist(), Hkv, D, ps, layers, gen)
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    kern = lambda l: paged_extend_attention(q, k[l], v[l], pt, kv_lens, cu, scale)
    plain = lambda l: paged_extend_attention_plain(q, k[l], v[l], pt, kv_lens, cu, scale)
    # library yardstick: one SDPA call over the batch when every sequence
    # has the same (q_len, kv_len), with the tail-aligned causal mask
    assert len(set(chunks)) == 1, "library yardstick needs one (q_len, kv_len)"
    ql, kl = chunks[0]
    B = len(chunks)
    slots = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(B, -1)[:, :kl]
    kd = [k[l].reshape(-1, Hkv, D)[slots].transpose(1, 2).contiguous() for l in range(layers)]
    vd = [v[l].reshape(-1, Hkv, D)[slots].transpose(1, 2).contiguous() for l in range(layers)]
    qd = q.view(B, ql, Hkv * G, D).transpose(1, 2).contiguous()
    if ql == kl:
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], is_causal=True, scale=scale, enable_gqa=True
        )
    else:
        mask = torch.arange(kl, device="cuda")[None, :] <= (
            kl - ql + torch.arange(ql, device="cuda")
        )[:, None]
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], attn_mask=mask, scale=scale, enable_gqa=True
        )
    attended = sum(q_ * (k_ - q_) + q_ * (q_ + 1) / 2 for q_, k_ in chunks)
    nbytes = T * Hkv * G * D * 2 * 2 + kv_total * Hkv * D * 2 * 2 + pt.numel() * 4
    flops = 4.0 * attended * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"{len(chunks)} x (q_len {ql}, kv_len {kl}) Hq={Hkv * G} Hkv={Hkv} D={D} page={ps}",
        ms=device_ms(kern, layers, 10),
        plain_ms=device_ms(plain, layers, 2, reps=3),
        library_ms=device_ms(lib, layers, 10),
        bound_ms=b,
        bound_by=by,
    )
    del kd, vd, k, v
    torch.cuda.empty_cache()
    return r


def phase_timing() -> dict:
    t = {
        "paged_decode_attention": [time_decode(64, 256), time_decode(64, 4096)],
        "paged_extend_attention": [
            time_extend([(128, 128)] * 64),
            time_extend([(2048, 8192)]),
        ],
    }
    for name, rows in t.items():
        for r in rows:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms"
            )
    return t


# --------------------------------------------------------------- phase 4


def prompt_logits(runner, prompt, next_token):
    """The model's logits after ``prompt`` (one extend) and after
    ``next_token`` (one decode step), on pages borrowed from the engine's
    idle pool and returned after."""
    import numpy as np

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

    ps, n = runner.page_size, len(prompt)
    pages = runner.page_allocator.alloc(-(-(n + 1) // ps))
    if pages is None:
        fail("no free pages for the logits check")
    try:
        pos = np.arange(n + 1)
        loc = pages[pos // ps] * ps + pos % ps
        common = dict(
            page_table=pages[None, :].astype(np.int32),
            sampling_info=SamplingBatchInfo.from_reqs([], 1, runner.model_config.vocab_size),
        )
        ext = WorkerBatch(
            mode=ForwardMode.EXTEND,
            tokens=np.asarray(prompt),
            positions=pos[:n],
            out_cache_loc=loc[:n],
            req_indices=np.zeros(n, np.int64),
            seq_lens=np.array([n]),
            extend_lens=np.array([n]),
            **common,
        )
        dec = WorkerBatch(
            mode=ForwardMode.DECODE,
            tokens=np.array([next_token]),
            positions=pos[n:],
            out_cache_loc=loc[n:],
            req_indices=np.zeros(1, np.int64),
            seq_lens=np.array([n + 1]),
            extend_lens=np.array([1]),
            **common,
        )
        return runner.forward_logits(ext)[0], runner.forward_logits(dec)[0]
    finally:
        runner.page_allocator.free(pages)


def phase_engine() -> dict:
    import numpy as np
    import torch

    from scratchpad_tpu_torch.config import ServerArgs
    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.ops.attention import (
        KERNEL_WRAPPERS,
        decode_attention_plain,
        extend_attention_plain,
        reset_launch_counts,
    )
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
    from scratchpad_tpu_torch.server.engine import Engine

    t0 = time.monotonic()
    engine = Engine(
        ServerArgs(
            preset="llama-3.2-1b", random_weights=True, dtype="bfloat16", device="cuda"
        )
    )
    runner = engine.scheduler.runner
    cfg = runner.model_config
    L = cfg.num_hidden_layers
    log(
        f"[engine] llama-3.2-1b bf16 ready in {time.monotonic() - t0:.1f} s: "
        f"{runner.param_bytes / 2**30:.2f} GiB params, "
        f"{runner.max_total_num_tokens} KV tokens"
    )
    model = runner.model
    forwards = {ForwardMode.EXTEND: 0, ForwardMode.DECODE: 0}
    inner_forward = model.forward

    def counting_forward(meta, kv):
        forwards[meta.mode] += 1
        return inner_forward(meta, kv)

    model.forward = counting_forward

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    shared = rng.integers(1, V, 600).tolist()
    chunk = engine.args.chunked_prefill_size
    prompts = [
        rng.integers(1, V, n).tolist() for n in (5, 37, 128, 300, 511, chunk + 952)
    ] + [shared + rng.integers(1, V, 40).tolist()]
    second = [shared + rng.integers(1, V, 25).tolist()]  # radix hit on `shared`
    sp = SamplingParams(temperature=0.0, max_new_tokens=32, ignore_eos=True)

    reset_launch_counts()
    outs = engine.generate(input_ids=prompts, sampling_params=[sp] * len(prompts))
    outs += engine.generate(input_ids=second, sampling_params=[sp])
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    torch.cuda.synchronize()
    n_ext, n_dec = forwards[ForwardMode.EXTEND], forwards[ForwardMode.DECODE]
    log(
        f"[engine] {len(outs)} requests: {n_ext} extend and {n_dec} decode forwards; "
        f"kernel launches {counts}"
    )
    for o, p in zip(outs, prompts + second):
        check(
            o.completion_tokens == 32 and len(o.output_ids) == 32 and o.finish_reason == "length",
            f"request {o.rid}: {o.completion_tokens} tokens, finish {o.finish_reason}",
        )
        check(o.prompt_tokens == len(p), f"request {o.rid}: prompt_tokens {o.prompt_tokens} != {len(p)}")
    check(outs[-1].cached_tokens >= 512, f"no radix hit: cached_tokens {outs[-1].cached_tokens}")
    log(f"[engine] radix hit: {outs[-1].cached_tokens} cached tokens; chunked prompt of {len(prompts[5])} tokens")
    check(
        counts["paged_extend_attention"] >= L * n_ext > 0,
        f"extend kernel launched {counts['paged_extend_attention']} < {L} x {n_ext}",
    )
    check(
        counts["paged_decode_attention"] >= L * n_dec > 0,
        f"decode kernel launched {counts['paged_decode_attention']} < {L} x {n_dec}",
    )
    steps = {"paged_extend_attention": n_ext, "paged_decode_attention": n_dec}

    # kernel path vs plain path logits for each prompt's first generated
    # token (extend) and the step after it (decode), on the card
    model.forward = inner_forward
    kern_attn = (model.decode_attention, model.extend_attention)
    plain_attn = (decode_attention_plain, extend_attention_plain)
    worst = {0: 0.0, 1: 0.0}  # by step: 0 = extend, 1 = decode
    agree = 0
    min_margin = math.inf  # the plain path's top-2 gap over max |logit|
    for p, o in zip(prompts + second, outs):
        logits = {}
        for label, (dec, ext) in (("kernel", kern_attn), ("plain", plain_attn)):
            model.decode_attention, model.extend_attention = dec, ext
            logits[label] = prompt_logits(runner, p, o.output_ids[0])
        model.decode_attention, model.extend_attention = kern_attn
        for step in (0, 1):
            a, b = logits["kernel"][step], logits["plain"][step]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), "non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst[step] = max(worst[step], rel)
            top2 = torch.topk(b, 2).values
            min_margin = min(min_margin, float(top2[0] - top2[1]) / scale)
            agree += int(a.argmax() == b.argmax())
            check(rel <= LOGIT_RTOL, f"kernel-path logits differ from the plain path by {rel:.3e} of max |logit|")
            check(bool(a.argmax() == b.argmax()), f"request {o.rid} step {step}: argmax differs")
    log(
        f"[engine] kernel vs plain logits over {2 * len(outs)} rows: worst "
        f"max|diff|/max|logit| {worst[0]:.3e} after the extend, {worst[1]:.3e} after "
        f"the decode step (tol {LOGIT_RTOL}); argmax agrees on {agree} of "
        f"{2 * len(outs)}; smallest plain top-2 gap {min_margin:.3e} of max|logit|"
    )
    return engine, dict(counts=counts, steps=steps)


def phase_engine_times(engine, eng: dict) -> None:
    """Decode tokens/s at the bench shape (bs 64, 128 + 128) and the
    device's busy share over one such run."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

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

    def run():
        engine.flush_cache()
        dec_time[0], dec_tokens[0] = 0.0, 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = engine.generate(input_ids=bench, sampling_params=[sp] * 64)
        wall = time.perf_counter() - t
        if any(len(r.output_ids) != 128 for r in res):
            fail("bench requests did not finish with 128 tokens")
        return dec_tokens[0] / dec_time[0], 64 * 128 / wall, wall

    run()  # warms the caching allocator and cuBLAS
    eng["decode_tok_s"], eng["e2e_tok_s"], _ = run()
    log(
        f"[engine] bs 64, 128+128: decode {eng['decode_tok_s']:.1f} tok/s "
        f"(time inside decode windows), {eng['e2e_tok_s']:.1f} tok/s end to end"
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = run()
    runner.run_decode_window = inner_window
    # device-side events only (kernels, copies, memsets): a CPU op's row
    # repeats the device time of the kernels it launched
    rows = [
        (e.key, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    busy_us = sum(t for _, t in rows)
    if busy_us > 0:
        eng["device_busy_share"] = busy_us / 1e6 / wall
        log(f"[profile] bs 64, 128+128 run: device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall")
        for key, t in sorted(rows, key=lambda r: -r[1])[:12]:
            log(f"[profile]   {t / 1e3:9.2f} ms  {key[:100]}")
    else:
        eng["device_busy_share"] = None
        log("[profile] the profiler recorded no device time: busy share not measured")


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
    errs = {"paged_decode_attention": 0.0, "paged_extend_attention": 0.0}
    check_decode(errs)
    check_extend(errs)
    engine, eng = phase_engine()
    if FAILURES:
        fail(f"{len(FAILURES)} correctness checks failed; the first: {FAILURES[0]}")
    phase_engine_times(engine, eng)
    del engine  # frees the pool and the weights for the kernel timings
    gc.collect()
    torch.cuda.empty_cache()
    timing = phase_timing()
    kernels = []
    for kname, meta in KERNELS.items():
        main_shape = timing[kname][0]  # the long-context rows are in the [time] lines
        kernels.append(
            dict(
                name=kname,
                **meta,
                launches=eng["counts"][kname],
                launches_per_forward=eng["counts"][kname] / max(eng["steps"][kname], 1),
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
    log(
        json.dumps(
            {
                "engine": {
                    "preset": "llama-3.2-1b",
                    "dtype": "bfloat16",
                    "shape": "bs 64, 128 prompt + 128 new tokens",
                    **{k: eng[k] for k in ("decode_tok_s", "e2e_tok_s", "device_busy_share")},
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
