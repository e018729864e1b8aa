"""What the port's measurement tools share: the device they run on, the
card's peak rates, and device time from CUDA events.

A tool runs on the card unless it is asked for the CPU (``--device cpu``),
where it runs the kernels' plain versions for the tests and times nothing:
a time taken on the CPU is never reported as a device time.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

# one H100 SXM (NVIDIA's data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default): the kernels, timed on the card; cpu: their plain "
        "versions, untimed (for the tests)",
    )


def resolve_device(name: str):
    """``torch.device(name)``; ``cuda`` with no card raises (no fallback)."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures the card (--device cpu runs "
                           "the plain versions, untimed)")
    if name == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def card() -> dict:
    """The card's name and ``nvidia-smi``'s name and power limit."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return {"device": torch.cuda.get_device_name(0), "smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else None}


def device_ms(fn, n_buffers: int = 1, iters: int = 20, reps: int = 5) -> float:
    """Median device milliseconds per call of ``fn(i)``. A sleep kernel holds
    the stream while the host enqueues ``iters`` calls, so the events time the
    device work back to back and not the host's launch rate. ``i`` cycles
    over ``n_buffers`` so that callers can keep the data out of the 50 MB L2
    between calls, as on the main path."""
    import torch

    for i in range(3):
        fn(i % n_buffers)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
        start.record()
        for i in range(iters):
            fn(i % n_buffers)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take: bytes at 3.35 TB/s or operations
    at ``peak``, whichever is larger, and which of the two it is."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")
