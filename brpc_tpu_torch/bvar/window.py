"""Window / PerSecond (a copy of ``brpc_tpu/bvar/window.py``): one
sampler thread per process snapshots every window's variable once a
second; a Window reports the delta over its last ``window_size``
seconds, PerSecond that delta over the span it covers."""
from __future__ import annotations

import threading
import time
import weakref

from .variable import Variable


class _SamplerThread:
    _instance = None
    _lock = threading.Lock()

    @classmethod
    def instance(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._samplers: list = []
        self._mu = threading.Lock()
        threading.Thread(target=self._run, daemon=True,
                         name="bvar-sampler").start()

    def add(self, sampler) -> None:
        # weak: a window whose owner is gone must become collectable
        with self._mu:
            self._samplers.append(weakref.ref(sampler))

    def _run(self):
        while True:
            start = time.monotonic()
            with self._mu:
                refs = list(self._samplers)
            dead = []
            for ref in refs:
                s = ref()
                if s is None:
                    dead.append(ref)
                    continue
                try:
                    s.take_sample()
                except Exception:  # pragma: no cover
                    pass
            if dead:
                with self._mu:
                    self._samplers = [r for r in self._samplers
                                      if r not in dead]
            time.sleep(max(0.0, 1.0 - (time.monotonic() - start)))


class Window(Variable):
    """Delta of ``var.get_value()`` over the last ``window_size``
    seconds."""

    def __init__(self, var, window_size: int = 10, name: str = ""):
        self._var = var
        self._window = max(1, window_size)
        self._samples: list[tuple[float, object]] = []
        self._mu = threading.Lock()
        _SamplerThread.instance().add(self)
        super().__init__(name)

    def take_sample(self):
        now = time.monotonic()
        v = self._var.get_value()
        with self._mu:
            self._samples.append((now, v))
            horizon = now - self._window - 2
            while self._samples and self._samples[0][0] < horizon:
                self._samples.pop(0)

    def _oldest_in_window(self):
        """(newest sample, the oldest sample inside the window)."""
        newest = self._samples[-1]
        target = newest[0] - self._window
        oldest = next((s for s in self._samples if s[0] >= target),
                      self._samples[0])
        return newest, oldest

    def get_value(self):
        with self._mu:
            if not self._samples:
                return 0
            (_, newest_v), (_, oldest_v) = self._oldest_in_window()
        return newest_v - oldest_v

    def get_span(self) -> float:
        with self._mu:
            if len(self._samples) < 2:
                return 1.0
            (newest_t, _), (oldest_t, _) = self._oldest_in_window()
        return max(1e-9, newest_t - oldest_t)


class PerSecond(Window):
    """The windowed delta over the window's span: a rate."""

    def get_value(self):
        return super().get_value() / self.get_span()
