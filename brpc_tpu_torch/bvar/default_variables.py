"""Process default variables -- cpu, rss, fds, threads, io (a copy of
``brpc_tpu/bvar/default_variables.py``).

:func:`expose_default_variables` exposes the set once per process; the
port's ``Server.start`` calls it, so every serving process carries its
own health beside its serving variables.
"""
from __future__ import annotations

import os
import resource
import threading
import time

from .reducer import PassiveStatus

_exposed = False
_expose_lock = threading.Lock()
_start_time = time.time()

_last_cpu: tuple[float, float] | None = None  # (wall, cpu_seconds)


def _cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _cpu_usage() -> float:
    """Fraction of one core used since the last sample (windowed, not
    a lifetime average)."""
    global _last_cpu
    now = time.monotonic()
    cpu = _cpu_seconds()
    if _last_cpu is None:
        _last_cpu = (now, cpu)
        return 0.0
    dw, dc = now - _last_cpu[0], cpu - _last_cpu[1]
    if dw >= 1.0:
        _last_cpu = (now, cpu)
    return round(dc / dw, 4) if dw > 0 else 0.0


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        # ru_maxrss is KB on Linux: the peak, not the current size
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def _thread_count() -> int:
    return threading.active_count()


def _loadavg() -> float:
    try:
        return round(os.getloadavg()[0], 2)
    except OSError:
        return 0.0


def _proc_io(field: str) -> int:
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k == field:
                    return int(v)
    except (OSError, ValueError):
        pass
    return -1


def expose_default_variables() -> None:
    """Idempotent; called by ``Server.start``."""
    global _exposed
    with _expose_lock:
        if _exposed:
            return
        _exposed = True
        PassiveStatus(_cpu_usage).expose("process_cpu_usage")
        PassiveStatus(_cpu_seconds).expose("process_cpu_seconds")
        PassiveStatus(_rss_bytes).expose("process_memory_resident_bytes")
        PassiveStatus(_fd_count).expose("process_fd_count")
        PassiveStatus(_thread_count).expose("process_thread_count")
        PassiveStatus(os.getpid).expose("process_pid")
        PassiveStatus(lambda: round(time.time() - _start_time, 1)) \
            .expose("process_uptime_seconds")
        PassiveStatus(_loadavg).expose("system_loadavg_1m")
        PassiveStatus(lambda: _proc_io("read_bytes")).expose(
            "process_io_read_bytes")
        PassiveStatus(lambda: _proc_io("write_bytes")).expose(
            "process_io_write_bytes")
