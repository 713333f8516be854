"""Collector -- shared, speed-limited sampling (a copy of
``brpc_tpu/bvar/collector.py``).

Submitting a sample is a cheap, speed-limited hand-off on the hot path;
the expensive half runs on one background thread over batches:

  * ``Collected`` -- a sample; ``dump_and_destroy()`` runs on the
    collector thread (or inside ``flush``), exactly once;
  * ``CollectorSpeedLimit`` -- a family's budget: at most
    ``max_per_second`` grabs per FIXED one-second window (a window
    boundary may admit up to 2x in an instant: bounded overhead is the
    contract, not smoothness);
  * ``Collector`` -- pending samples per family and one daemon drainer;
    ``flush(family)`` drains one family on the calling thread, so a
    reader observes its own prior submissions without doing another
    family's work.

rpcz rides it when the native span queue is off (``rpcz.submit``).
"""
from __future__ import annotations

import threading
import time

from .reducer import Adder


class Collected:
    """A sample.  Subclasses implement dump_and_destroy(); it runs on
    the collector thread (or inside flush()), exactly once."""

    def dump_and_destroy(self) -> None:
        raise NotImplementedError


class CollectorSpeedLimit:
    """Fixed-window budget: at most `max_per_second` grabs per window.
    `clock` is injectable for deterministic tests."""

    def __init__(self, name: str, max_per_second: int = 1000,
                 clock=time.monotonic):
        self.name = name
        self.max_per_second = max_per_second
        self._clock = clock
        self._mu = threading.Lock()
        self._window_start = clock()
        self._in_window = 0
        self.grabbed = Adder(f"collector_{name}_grabbed")
        self.denied = Adder(f"collector_{name}_denied")

    def grab(self) -> bool:
        return self.grab_n(1) == 1

    def grab_n(self, n: int) -> int:
        """Grab up to `n` slots in ONE window check; returns how many
        were granted.  The span queue's drainer takes a whole batch's
        budget at once: one lock round trip and one clock read per
        drain, not per span."""
        now = self._clock()
        with self._mu:
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._in_window = 0
            granted = max(0, min(n, self.max_per_second
                                 - self._in_window))
            self._in_window += granted
        if granted:
            self.grabbed.add(granted)
        if n > granted:
            self.denied.add(n - granted)
        return granted


_limits: dict[str, CollectorSpeedLimit] = {}
_limits_lock = threading.Lock()


def get_or_create_limit(name: str,
                        max_per_second: int = 1000) -> CollectorSpeedLimit:
    """The shared limit of family `name`, created at the first call."""
    limit = _limits.get(name)
    if limit is None:
        with _limits_lock:
            limit = _limits.get(name)
            if limit is None:
                limit = CollectorSpeedLimit(name, max_per_second)
                _limits[name] = limit
    return limit


class Collector:
    _instance = None
    _instance_lock = threading.Lock()

    GRAB_INTERVAL_S = 0.1   # the drainer's cadence

    @classmethod
    def instance(cls) -> "Collector":
        # lock-free fast path: this runs on every submission
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._mu = threading.Lock()
        # per-family drain locks: flush("rpcz") neither performs nor
        # waits on another family's in-flight work
        self._drain_locks: dict[str, threading.Lock] = {}
        self._pending: dict[str, list[Collected]] = {}
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def submit(self, sample: Collected,
               limit: CollectorSpeedLimit | None = None,
               family: str = "default") -> bool:
        """Hot-path hand-off.  Returns False when the speed limit dropped
        the sample (its dump_and_destroy never runs)."""
        if limit is not None and not limit.grab():
            return False
        with self._mu:
            self._pending.setdefault(family, []).append(sample)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="bvar-collector")
                self._thread.start()
        self._wake.set()
        return True

    def flush(self, family: str | None = None) -> None:
        """Drain one family (or all, family=None) on THIS thread."""
        self._drain(family)

    def _drain_lock(self, family: str) -> threading.Lock:
        with self._mu:
            lock = self._drain_locks.get(family)
            if lock is None:
                lock = self._drain_locks[family] = threading.Lock()
            return lock

    def _drain(self, family: str | None = None) -> None:
        if family is None:
            with self._mu:
                families = list(self._pending.keys())
            for f in families:
                self._drain(f)
            return
        with self._drain_lock(family):
            with self._mu:
                batch = self._pending.pop(family, None)
            t_cpu0 = time.thread_time()
            for s in batch or ():
                try:
                    s.dump_and_destroy()
                except Exception:
                    pass  # a broken sample must never kill the drainer
            if batch and family == "rpcz":
                # the heavyweight half of span submission runs here
                from ..butil import hostcpu
                hostcpu.add("span_submit",
                            (time.thread_time() - t_cpu0) * 1e6)

    def _run(self) -> None:
        while True:
            self._wake.wait(self.GRAB_INTERVAL_S)
            self._wake.clear()
            self._drain()
