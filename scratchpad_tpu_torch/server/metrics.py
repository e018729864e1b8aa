"""Request latency samples and the Prometheus ``/metrics`` exposition.

Counterpart of ``scratchpad_tpu/server/metrics.py`` on the standard
library: the JAX module's ``ServerMetrics`` registers its gauges, counters
and histograms with ``prometheus_client``; this one keeps the same names,
types, help strings and bucket ladders and writes the text exposition
(format 0.0.4, the ``_created`` series included) by hand.

``LatencyStats``: the Engine feeds it from its single event funnel
(``Engine._postprocess_event``): TTFT on the first token, ITL per
subsequent token (window-amortised: the host sees a fused decode window's K
tokens at once, so the window gap is recorded as K equal inter-token
samples), and TPOT/E2E when a request finishes.
"""

from __future__ import annotations

import collections
import math
import time

# seconds; the JAX package's ladders (scratchpad_tpu/server/metrics.py:34-45)
_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    20.0, 40.0, 80.0,
)
_ITL_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)
_E2E_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0,
)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class LatencyStats:
    """Bounded sample queues."""

    MAX = 1 << 16

    def __init__(self):
        self.ttft = collections.deque(maxlen=self.MAX)
        self.itl = collections.deque(maxlen=self.MAX)  # (gap_seconds, count)
        self.tpot = collections.deque(maxlen=self.MAX)
        self.e2e = collections.deque(maxlen=self.MAX)
        self.queue_time = collections.deque(maxlen=self.MAX)
        self.finished_by_reason = collections.Counter()

    def on_tokens(self, req, n_new: int, now: float | None = None) -> None:
        """Record token arrival for ``req`` (n_new tokens surfaced now)."""
        now = time.monotonic() if now is None else now
        if req.first_token_at is None:
            req.first_token_at = now
            self.ttft.append(now - req.created_at)
        else:
            gap = now - (req.last_token_at or req.first_token_at)
            if n_new > 0:
                self.itl.append((gap / n_new, n_new))
        req.last_token_at = now

    def on_finish(self, req) -> None:
        if req.stats_done:
            return
        req.stats_done = True
        end = req.finished_at or time.monotonic()
        self.e2e.append(end - req.created_at)
        if req.first_token_at is not None:
            self.queue_time.append(req.first_token_at - req.created_at)
            n = len(req.output_ids)
            if n > 1:
                self.tpot.append(
                    ((req.last_token_at or end) - req.first_token_at) / (n - 1)
                )
        reason = req.finished_reason
        self.finished_by_reason[reason.to_openai() if reason else "abort"] += 1


def _go_float(d: float) -> str:
    """A sample value as the Prometheus text format writes it (Go's
    exponent rule for positive values, as ``prometheus_client`` does)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class _Histogram:
    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # the last: +Inf
        self.sum = 0.0
        self.created = time.time()

    def observe(self, v: float, n: int = 1) -> None:
        i = next((i for i, b in enumerate(self.buckets) if v <= b), len(self.buckets))
        self.counts[i] += n
        self.sum += v * n


class ServerMetrics:
    """The ``/metrics`` scrape: gauges read the scheduler at scrape time,
    counters advance by the delta of its cumulative tallies, histograms
    drain the engine's ``LatencyStats``."""

    PREFIX = "scratchpad_tpu"

    def __init__(self, engine):
        self.engine = engine
        self.created = time.time()
        self.gauges = {
            "num_running_reqs": ("running requests", 0.0),
            "num_waiting_reqs": ("queued requests", 0.0),
            "token_usage": ("KV pool usage fraction", 0.0),
            "radix_cache_pages": ("radix tree pages", 0.0),
            "gen_throughput": ("decode tokens/s since last scrape", 0.0),
        }
        self.counters = {
            "generation_tokens": ["generated tokens", 0.0],
            "prompt_tokens": ["prefill tokens computed", 0.0],
            "num_retractions": ["retractions", 0.0],
        }
        self.finished: dict[str, list] = {}  # reason -> [count, created]
        self.histograms = {
            "time_to_first_token_seconds": ("TTFT", _Histogram(_TTFT_BUCKETS)),
            "inter_token_latency_seconds": (
                "inter-token latency (fused windows amortised per token)",
                _Histogram(_ITL_BUCKETS),
            ),
            "time_per_output_token_seconds": (
                "per-request mean time per output token after the first",
                _Histogram(_ITL_BUCKETS),
            ),
            "e2e_request_latency_seconds": ("end-to-end request latency", _Histogram(_E2E_BUCKETS)),
        }
        self._last = {"gen": 0, "prefill": 0, "retract": 0, "t": time.monotonic()}
        self._reasons_seen: collections.Counter = collections.Counter()

    def collect(self) -> None:
        sched = self.engine.scheduler
        now = time.monotonic()
        d_gen = sched.num_generated_tokens - self._last["gen"]
        total = sched.allocator.num_pages
        tree = sched.tree_cache
        for name, v in (
            ("num_running_reqs", sched.num_running()),
            ("num_waiting_reqs", sched.num_queued()),
            ("token_usage", 1.0 - sched.allocator.available_pages / max(total, 1)),
            ("radix_cache_pages", tree.evictable_pages + tree.protected_pages),
            ("gen_throughput", d_gen / max(now - self._last["t"], 1e-9)),
        ):
            self.gauges[name] = (self.gauges[name][0], float(v))
        self.counters["generation_tokens"][1] += d_gen
        self.counters["prompt_tokens"][1] += sched.num_prefill_tokens - self._last["prefill"]
        self.counters["num_retractions"][1] += sched.num_retractions - self._last["retract"]
        self._last = {
            "gen": sched.num_generated_tokens,
            "prefill": sched.num_prefill_tokens,
            "retract": sched.num_retractions,
            "t": now,
        }
        stats: LatencyStats = self.engine.latency
        h = {k: v[1] for k, v in self.histograms.items()}
        while stats.ttft:
            h["time_to_first_token_seconds"].observe(stats.ttft.popleft())
        while stats.itl:
            gap, n = stats.itl.popleft()
            h["inter_token_latency_seconds"].observe(gap, min(n, 1024))
        while stats.tpot:
            h["time_per_output_token_seconds"].observe(stats.tpot.popleft())
        while stats.e2e:
            h["e2e_request_latency_seconds"].observe(stats.e2e.popleft())
        for reason, n in stats.finished_by_reason.items():
            d = n - self._reasons_seen[reason]
            if d:
                self.finished.setdefault(reason, [0, time.time()])[0] += d
                self._reasons_seen[reason] = n

    def render(self) -> bytes:
        """Collect, then the text exposition of every metric."""
        self.collect()
        p = self.PREFIX
        out: list[str] = []

        def family(name, help_, kind, samples):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            out.extend(f"{n}{labels} {_go_float(v)}" for n, labels, v in samples)

        for name, (help_, v) in self.gauges.items():
            family(f"{p}:{name}", help_, "gauge", [(f"{p}:{name}", "", v)])

        def counter(name, help_, rows):  # rows: (labels, value, created)
            family(f"{name}_total", help_, "counter", [(f"{name}_total", lb, v) for lb, v, _ in rows])
            family(f"{name}_created", help_, "gauge", [(f"{name}_created", lb, c) for lb, _, c in rows])

        for name, (help_, v) in self.counters.items():
            counter(f"{p}:{name}", help_, [("", v, self.created)])
        counter(
            f"{p}:num_finished_reqs",
            "finished requests",
            [(f'{{reason="{r}"}}', n, c) for r, (n, c) in self.finished.items()],
        )
        for name, (help_, hist) in self.histograms.items():
            full = f"{p}:{name}"
            samples, acc = [], 0
            for b, n in zip(hist.buckets + (math.inf,), hist.counts):
                acc += n
                samples.append((f"{full}_bucket", f'{{le="{_go_float(b)}"}}', acc))
            samples += [(f"{full}_count", "", acc), (f"{full}_sum", "", hist.sum)]
            family(full, help_, "histogram", samples)
            family(f"{full}_created", help_, "gauge", [(f"{full}_created", "", hist.created)])
        return ("\n".join(out) + "\n").encode()
