"""Concurrency limiters (a copy of
``brpc_tpu/policy/concurrency_limiter.py``).

"constant": a fixed cap.  "auto": a gradient limiter -- tracks the EMA
of the no-load latency and the recent peak qps, sets limit ~ peak_qps x
min_latency x (1 + alpha), with a periodic downward exploration to
re-measure the minimum latency.  "timeout": rejects when the estimated
queueing delay exceeds the budget.
"""
from __future__ import annotations

import threading
import time


class ConcurrencyLimiter:
    def on_requested(self, current_concurrency: int) -> bool:
        raise NotImplementedError

    def on_responded(self, error_code: int, latency_us: int) -> None:
        pass

    def max_concurrency(self) -> int:
        return 0


class ConstantLimiter(ConcurrencyLimiter):
    def __init__(self, limit: int):
        self._limit = int(limit)

    def on_requested(self, current_concurrency: int) -> bool:
        return self._limit <= 0 or current_concurrency <= self._limit

    def max_concurrency(self) -> int:
        return self._limit


class AutoConcurrencyLimiter(ConcurrencyLimiter):
    ALPHA = 0.3            # headroom over the latency-bandwidth product
    EMA_DECAY = 0.9
    SAMPLE_WINDOW_S = 1.0
    EXPLORE_EVERY = 20     # windows between downward explorations
    MIN_LIMIT = 8

    def __init__(self):
        self._mu = threading.Lock()
        self._limit = 64
        self._min_latency_us = None     # EMA of observed floor
        self._window_start = time.monotonic()
        self._window_count = 0
        self._window_lat_sum = 0
        self._windows_seen = 0
        self._exploring = False

    def on_requested(self, current_concurrency: int) -> bool:
        return current_concurrency <= self._limit

    def on_responded(self, error_code: int, latency_us: int) -> None:
        if error_code != 0:
            return
        with self._mu:
            self._window_count += 1
            self._window_lat_sum += latency_us
            now = time.monotonic()
            span = now - self._window_start
            if span < self.SAMPLE_WINDOW_S or self._window_count < 4:
                return
            avg_lat = self._window_lat_sum / self._window_count
            qps = self._window_count / span
            self._window_start = now
            self._window_count = 0
            self._window_lat_sum = 0
            self._windows_seen += 1
            if self._min_latency_us is None:
                self._min_latency_us = avg_lat
            elif self._exploring or avg_lat < self._min_latency_us:
                # during exploration the server is unloaded: trust the sample
                self._min_latency_us = (self.EMA_DECAY * self._min_latency_us +
                                        (1 - self.EMA_DECAY) * avg_lat)
            # latency-bandwidth product with headroom
            target = qps * (self._min_latency_us / 1e6) * (1 + self.ALPHA)
            if self._exploring:
                self._exploring = False
                self._limit = max(self.MIN_LIMIT, int(target) + 1)
            elif self._windows_seen % self.EXPLORE_EVERY == 0:
                # drop concurrency to re-measure the no-load latency floor
                self._exploring = True
                self._limit = max(self.MIN_LIMIT, self._limit // 2)
            else:
                self._limit = max(self.MIN_LIMIT, int(
                    0.5 * self._limit + 0.5 * (target + 1)))

    def max_concurrency(self) -> int:
        return self._limit


class TimeoutLimiter(ConcurrencyLimiter):
    """Reject when expected wait (concurrency × avg latency) exceeds the
    budget (reference timeout_concurrency_limiter)."""

    def __init__(self, timeout_ms: float = 500.0):
        self._timeout_us = timeout_ms * 1e3
        self._avg_latency_us = 0.0
        self._mu = threading.Lock()

    def on_requested(self, current_concurrency: int) -> bool:
        if self._avg_latency_us <= 0:
            return True
        return current_concurrency * self._avg_latency_us <= self._timeout_us

    def on_responded(self, error_code: int, latency_us: int) -> None:
        if error_code != 0:
            return
        with self._mu:
            if self._avg_latency_us == 0:
                self._avg_latency_us = latency_us
            else:
                self._avg_latency_us = (0.9 * self._avg_latency_us +
                                        0.1 * latency_us)


def create_limiter(spec) -> ConcurrencyLimiter:
    """spec: int (constant), "auto", "constant:N", "timeout[:ms]" —
    the adaptive string-typed option scheme (§5.9)."""
    if isinstance(spec, ConcurrencyLimiter):
        return spec
    if isinstance(spec, int):
        return ConstantLimiter(spec)
    s = str(spec).strip().lower()
    if s == "auto":
        return AutoConcurrencyLimiter()
    if s.startswith("timeout"):
        _, _, ms = s.partition(":")
        return TimeoutLimiter(float(ms) if ms else 500.0)
    if s.startswith("constant:"):
        return ConstantLimiter(int(s.split(":", 1)[1]))
    return ConstantLimiter(int(s))
