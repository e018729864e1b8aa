"""Request latency samples.

Counterpart of ``LatencyStats`` in ``scratchpad_tpu/server/metrics.py``,
kept in a module of its own: the JAX package's module also holds the
Prometheus ``/metrics`` handler and so imports ``aiohttp`` and
``prometheus_client``, which the engine does not need.

The Engine feeds it from its single event funnel
(``Engine._postprocess_event``): TTFT on the first token, ITL per
subsequent token (window-amortised: the host sees a fused decode window's K
tokens at once, so the window gap is recorded as K equal inter-token
samples), and TPOT/E2E when a request finishes.
"""

from __future__ import annotations

import collections
import time


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
