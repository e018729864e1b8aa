#!/usr/bin/env python3
"""Sum the device time of a ``torch.profiler`` trace, by op and by category.

    python -m scratchpad_tpu_torch.tools.analyze_trace TRACE.json[.gz] [--top 30]

Counterpart of ``tools/analyze_trace.py``, which reads a TPU profile's
``xplane.pb`` through TensorFlow. This one reads the chrome trace that
``torch.profiler.profile.export_chrome_trace`` writes (gzipped where the
name ends in ``.gz``) and takes its device events: kernels, memcpys and
memsets (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``). It prints the
device's busy time over the span from the first device event's start to the
last one's end, the time by category, and the top ops (total, count, mean).

Categories (``category``): ``port kernel`` (a ``__global__`` function of the
port's ``csrc/``), ``matmul`` (cuBLAS, whose JIT kernels are named ``nvjet_*``,
CUTLASS, gemm, xmma), ``elementwise``,
``reduce``, ``copy`` (memcpys and copy kernels), ``memset``, ``other``.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def port_kernel_names(csrc: Path = CSRC) -> tuple[str, ...]:
    """The names of the ``__global__`` functions in the port's CUDA sources
    and headers."""
    names = set()
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = src.read_text()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))
    return tuple(sorted(names))


def category(name: str, cat: str, port_kernels=()) -> str:
    n = name.lower()
    if cat == "gpu_memset" or "memset" in n:
        return "memset"
    if cat == "gpu_memcpy" or "memcpy" in n:
        return "copy"
    if any(re.search(rf"\b{k}\b", name) for k in port_kernels):
        return "port kernel"
    if any(w in n for w in ("gemm", "cutlass", "cublas", "xmma", "matmul", "sm90_", "nvjet")):
        return "matmul"
    if "reduce" in n:
        return "reduce"
    if "copy" in n or "cat_" in n:
        return "copy"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def load_events(path) -> list[dict]:
    """The device events (``ph`` "X" in a device category) of a chrome trace."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def rollup(events, port_kernels=None) -> dict:
    """``{"busy_us", "span_us", "by_category": {cat: us}, "by_op": {name: (us,
    count)}}``; times in µs, as the trace keeps them."""
    if port_kernels is None:
        port_kernels = port_kernel_names()
    by_cat = collections.Counter()
    by_op = collections.Counter()
    count = collections.Counter()
    lo = hi = None
    for e in events:
        dur = float(e.get("dur", 0.0))
        ts = float(e["ts"])
        name = e.get("name", "?")
        by_op[name] += dur
        count[name] += 1
        by_cat[category(name, e["cat"], port_kernels)] += dur
        lo = ts if lo is None else min(lo, ts)
        hi = ts + dur if hi is None else max(hi, ts + dur)
    return {
        "busy_us": sum(by_cat.values()),
        "span_us": 0.0 if lo is None else hi - lo,
        "by_category": dict(by_cat.most_common()),
        "by_op": {n: (us, count[n]) for n, us in by_op.most_common()},
    }


def report(r: dict, top: int = 30) -> list[str]:
    """Lines as ``tools/analyze_trace.py:101-115`` prints them."""
    busy, span = r["busy_us"], r["span_us"]
    lines = [f"device busy time: {busy / 1e3:.3f} ms over a {span / 1e3:.3f} ms span "
             f"({100 * busy / max(span, 1e-9):.1f}% occupancy)", "by category:"]
    for cat, us in r["by_category"].items():
        lines.append(f"  {cat:18s} {us / 1e3:9.3f} ms  {100 * us / max(busy, 1e-9):5.1f}%")
    lines.append(f"top {top} ops (total | count | mean):")
    for name, (us, n) in list(r["by_op"].items())[:top]:
        lines.append(f"  {us / 1e3:9.3f} ms  x{n:<6d} {us / n:8.1f} us  {name[:110]}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    events = load_events(args.trace)
    if not events:
        raise SystemExit(f"{args.trace}: no device events (kernel, gpu_memcpy, gpu_memset)")
    r = rollup(events)
    print("\n".join(report(r, args.top)), flush=True)
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
