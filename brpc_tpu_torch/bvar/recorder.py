"""IntRecorder and LatencyRecorder (a copy of
``brpc_tpu/bvar/recorder.py``'s).

``LatencyRecorder`` is native, as the reference's is: ``add`` is one
call into the port's own core (``libbrpc_core_torch.so``,
``brpc_latency_*`` in ``src/cc/capi.cc``) writing the calling thread's
cells -- count, sum, max and a log-bucket histogram -- and reads merge
the cells natively.  The core is built and loaded at the first
recorder (``_core/lib.py``); a failed build raises.

The core has 512 recorder slots a process, and a recorder made once they
are all live gets one that silently records nothing (the reference's
recorders then read 0).  The port counts the live slots and raises
instead, after a garbage collection has given back what it can.
"""
from __future__ import annotations

import ctypes
import gc
import threading

from .._core import lib as _lib
from .reducer import Adder, PassiveStatus
from .variable import Variable
from .window import PerSecond, Window


class IntRecorder(Variable):
    """Average of the recorded values."""

    def __init__(self, name: str = ""):
        self._sum = Adder()
        self._count = Adder()
        super().__init__(name)

    def add(self, v) -> "IntRecorder":
        self._sum.add(v)
        self._count.add(1)
        return self

    def __lshift__(self, v):
        return self.add(v)

    def get_value(self):
        c = self._count.get_value()
        return self._sum.get_value() / c if c else 0


# the core's recorder slots (kMaxLatencyRecs, src/cc/bvar/combiner.h)
NATIVE_SLOTS = 512
_slots_mu = threading.Lock()
_slots_live = 0


def native_slots_live() -> int:
    """Native recorder slots held by live recorders."""
    return _slots_live


def _take_slot() -> None:
    """Count one more live slot; raise when every slot is live, once
    unreachable recorders have been collected."""
    global _slots_live
    for attempt in range(2):
        with _slots_mu:
            if _slots_live < NATIVE_SLOTS:
                _slots_live += 1
                return
        if attempt == 0:
            gc.collect()
    raise RuntimeError(f"all {NATIVE_SLOTS} native latency recorder "
                       f"slots are live")


def _give_slot() -> None:
    global _slots_live
    with _slots_mu:
        _slots_live -= 1


def _native_stats(stats_fn, handle) -> tuple:
    """``(count, sum_us, max_us)`` of one native recorder."""
    c, s, m = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    stats_fn(handle, ctypes.byref(c), ctypes.byref(s), ctypes.byref(m))
    return c.value, s.value, m.value


class _NativeStat:
    """One field of a native recorder, shaped as a variable so a Window
    can sample it (holds the handle, not the recorder: no cycle delays
    the recorder's ``__del__``)."""

    __slots__ = ("_stats", "_h", "_field")

    def __init__(self, stats_fn, handle, field: int):
        self._stats, self._h, self._field = stats_fn, handle, field

    def get_value(self):
        return _native_stats(self._stats, self._h)[self._field]


class LatencyRecorder(Variable):
    """``<< latency_us`` records one call.  When named it exposes
    ``<name>_latency`` (windowed average, us), ``_max_latency``,
    ``_qps``, ``_count`` and ``_latency_{50,90,99,999,9999}``."""

    def __init__(self, name: str = "", window_size: int = 10):
        core, _ = _lib.load()
        _take_slot()
        self._h = core.brpc_latency_new()
        if not self._h:
            _give_slot()
            raise RuntimeError("the native core has no free latency "
                               "recorder slot")
        self._record = core.brpc_latency_record
        self._stats = core.brpc_latency_stats
        self._percentile = core.brpc_latency_percentile
        self._free = core.brpc_latency_free   # kept for __del__
        self._num = _NativeStat(self._stats, self._h, 0)
        self._sum = _NativeStat(self._stats, self._h, 1)
        self._win_sum = Window(self._sum, window_size)
        self._win_num = Window(self._num, window_size)
        self._qps = PerSecond(self._num, window_size)
        super().__init__(name)

    def expose(self, name: str):
        super().expose(name + "_latency")
        PassiveStatus(self.max_latency).expose(name + "_max_latency")
        PassiveStatus(lambda: round(self._qps.get_value(), 1)).expose(
            name + "_qps")
        PassiveStatus(self.count).expose(name + "_count")
        for p, label in ((0.5, "50"), (0.9, "90"), (0.99, "99"),
                         (0.999, "999"), (0.9999, "9999")):
            PassiveStatus(lambda p=p: round(self.latency_percentile(p), 1)
                          ).expose(f"{name}_latency_{label}")
        return self

    def add(self, latency_us) -> "LatencyRecorder":
        self._record(self._h, int(latency_us))
        return self

    def __lshift__(self, latency_us):
        return self.add(latency_us)

    def snapshot(self) -> tuple:
        """``(count, sum_us, max_us)`` in one native call."""
        return _native_stats(self._stats, self._h)

    def get_value(self):
        """Windowed average latency in us."""
        n = self._win_num.get_value()
        return self._win_sum.get_value() / n if n else 0

    def latency(self) -> float:
        return self.get_value()

    def latency_percentile(self, ratio: float) -> float:
        return self._percentile(self._h, float(ratio))

    def max_latency(self):
        return self.snapshot()[2]

    def count(self):
        return self.snapshot()[0]

    def qps(self) -> float:
        return self._qps.get_value()

    def __del__(self):
        # the core has 512 recorder slots per process: give this one back
        h = getattr(self, "_h", None)
        if h:
            try:
                self._free(h)
            except Exception:
                pass
            self._h = None
            _give_slot()
