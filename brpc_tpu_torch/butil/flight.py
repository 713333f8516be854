"""The native flight recorder's Python surface (a copy of
``brpc_tpu/butil/flight.py`` over the port's core,
``src/cc/butil/flight.h``).

The core records its load-bearing transitions -- executor task begin
and end, steal, park and unpark, butex wait, wake and timeout, timer
fire and cancel, socket life and its read and write syscalls, token
ring push, pop and terminal -- into always-on per-thread rings that
overwrite their oldest event.  This module parses the native text dumps
into events and a per-thread table, feeds the ``/flightrecorder``
console page, exposes the recorder's and the syscall counters on
``/vars`` and ``/brpc_metrics``, and renders the text report a wedge
autopsy prints.

One difference from the JAX package: there the recorder degrades to
empty results when its native core failed to build.  The port's core is
required by its RPC front and always built (a failed build raises), so
``available()`` is true wherever the port runs.
"""
from __future__ import annotations

import ctypes

from .._core import lib as _lib
from ..flags import define_flag, get_flag

define_flag("flight_recorder_enabled", True,
            "record native-core transitions (executor/butex/timer/"
            "socket/token-ring) into the always-on per-thread flight "
            "rings; off = the record hook is a single relaxed-load "
            "no-op", reloadable=True)

# bytes-per-write histogram bucket labels (log2 from 64 B; the last
# bucket is open-ended): must match Socket::kWriteHistBuckets
WRITE_HIST_BUCKETS = 16
WRITE_HIST_LABELS = tuple(
    str(64 << i) for i in range(WRITE_HIST_BUCKETS - 1)) + ("+inf",)


def _core():
    """The port's core (loaded, and where missing built, on first
    use)."""
    return _lib.load()[0]


def available() -> bool:
    return _core() is not None


def enabled() -> bool:
    return bool(_core().brpc_flight_enabled())


def set_enabled(on: bool) -> None:
    _core().brpc_flight_enable(1 if on else 0)


def apply_flag() -> None:
    """Push the reloadable flag's value into the core (the ``/flags``
    side effect)."""
    set_enabled(bool(get_flag("flight_recorder_enabled", True)))


def stats() -> dict:
    ev, th, dr = (ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64())
    _core().brpc_flight_stats(ctypes.byref(ev), ctypes.byref(th),
                              ctypes.byref(dr))
    return {"events": ev.value, "threads": th.value, "dropped": dr.value}


def events(limit: int = 512) -> list[dict]:
    """The merged time-ordered tail of every native thread's ring,
    oldest first."""
    buf = ctypes.create_string_buffer(1 << 20)
    n = _core().brpc_flight_dump(buf, len(buf), int(limit))
    out = []
    if n <= 0:
        return out
    for line in buf.value.decode("utf-8", "replace").splitlines():
        parts = line.split()
        # <ts_us> <tid> <name> <kind> a=0x<hex> b=<dec>
        if len(parts) != 6:
            continue
        try:
            out.append({
                "ts_us": int(parts[0]),
                "tid": int(parts[1]),
                "thread": parts[2],
                "kind": parts[3],
                "a": int(parts[4][2:], 16),
                "b": int(parts[5][2:]),
            })
        except ValueError:
            continue
    return out


def threads() -> list[dict]:
    """The per-thread table: what every native thread last did, and how
    long ago."""
    buf = ctypes.create_string_buffer(1 << 18)
    n = _core().brpc_flight_threads(buf, len(buf))
    out = []
    if n <= 0:
        return out
    for line in buf.value.decode("utf-8", "replace").splitlines():
        parts = line.split()
        # <tid> <name> <live|exited> events= dropped= last= age_us=
        if len(parts) != 7:
            continue
        try:
            kv = dict(p.split("=", 1) for p in parts[3:])
            out.append({
                "tid": int(parts[0]),
                "thread": parts[1],
                "live": parts[2] == "live",
                "events": int(kv["events"]),
                "dropped": int(kv["dropped"]),
                "last": kv["last"],
                "age_us": int(kv["age_us"]),
            })
        except (ValueError, KeyError):
            continue
    return out


def syscall_counters() -> dict:
    """Process-wide read and write syscall counts, and the dispatch
    write batch's coalescing hits and misses."""
    vals = [ctypes.c_int64() for _ in range(4)]
    _core().brpc_syscall_counters(*[ctypes.byref(v) for v in vals])
    return {"read_syscalls": vals[0].value,
            "write_syscalls": vals[1].value,
            "batch_hits": vals[2].value,
            "batch_misses": vals[3].value}


def write_size_hist() -> dict:
    """The bytes-per-write histogram: ``{bucket upper bound: count}``."""
    arr = (ctypes.c_int64 * WRITE_HIST_BUCKETS)()
    n = _core().brpc_write_size_hist(arr, WRITE_HIST_BUCKETS)
    return {WRITE_HIST_LABELS[i]: arr[i] for i in range(n)}


def socket_syscalls(sid: int) -> dict | None:
    """One socket's read and write syscall counts, or None for a stale
    or failed id."""
    rd, wr = ctypes.c_int64(), ctypes.c_int64()
    if _core().brpc_socket_syscalls(ctypes.c_uint64(sid), ctypes.byref(rd),
                                    ctypes.byref(wr)) != 0:
        return None
    return {"read_syscalls": rd.value, "write_syscalls": wr.value}


def report(limit: int = 120) -> str:
    """The wedge-autopsy text: the recorder's stats, the per-thread
    table (every native thread's last event and its age), then the
    merged event tail -- which worker, socket or butex stopped
    advancing, and what it last did."""
    st = stats()
    sc = syscall_counters()
    lines = [
        f"flight recorder: {'ENABLED' if enabled() else 'DISABLED'} · "
        f"{st['threads']} threads · {st['events']} events recorded "
        f"({st['dropped']} overwritten)",
        f"syscalls: read={sc['read_syscalls']} "
        f"write={sc['write_syscalls']} "
        f"batch_hits={sc['batch_hits']} "
        f"batch_misses={sc['batch_misses']}",
        "",
        "--- per-thread state (last event of every native thread) ---",
    ]
    for t in threads():
        lines.append(
            f"  tid={t['tid']:<8} {t['thread']:<12} "
            f"{'live' if t['live'] else 'exited':<7} "
            f"last={t['last']:<14} age_us={t['age_us']:<12} "
            f"events={t['events']} dropped={t['dropped']}")
    lines.append("")
    lines.append(f"--- merged event tail (oldest first, "
                 f"last {limit}) ---")
    for e in events(limit):
        lines.append(f"  {e['ts_us']} {e['thread']:<12} "
                     f"{e['kind']:<14} a=0x{e['a']:x} b={e['b']}")
    return "\n".join(lines) + "\n"


_exposed = False


def expose_flight_variables() -> None:
    """The recorder's and the syscall counters on ``/vars`` and
    ``/brpc_metrics`` (idempotent; ``Server.start`` calls it beside
    ``expose_default_variables``)."""
    global _exposed
    if _exposed:
        return
    _exposed = True
    from ..bvar.multi_dimension import MultiDimension
    from ..bvar.reducer import PassiveStatus

    PassiveStatus(lambda: stats()["events"]) \
        .expose("flight_events_recorded")
    PassiveStatus(lambda: stats()["threads"]) \
        .expose("flight_threads_tracked")
    PassiveStatus(lambda: stats()["dropped"]) \
        .expose("flight_events_overwritten")
    PassiveStatus(lambda: int(enabled())).expose("flight_enabled")
    PassiveStatus(lambda: syscall_counters()["read_syscalls"]) \
        .expose("socket_read_syscalls")
    PassiveStatus(lambda: syscall_counters()["write_syscalls"]) \
        .expose("socket_write_syscalls")
    PassiveStatus(lambda: syscall_counters()["batch_hits"]) \
        .expose("socket_write_batch_hits")
    PassiveStatus(lambda: syscall_counters()["batch_misses"]) \
        .expose("socket_write_batch_misses")

    # the bytes-per-write histogram as a labelled bvar: /brpc_metrics
    # renders socket_bytes_per_write{le="64"} ...
    md = MultiDimension(["le"], lambda: None,
                        name="socket_bytes_per_write")
    for label in WRITE_HIST_LABELS:
        md._stats[(label,)] = PassiveStatus(
            (lambda lb: lambda: write_size_hist().get(lb, 0))(label))
