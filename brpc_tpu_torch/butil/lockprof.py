"""Lock-contention ledger and lock-order witness (a copy of
``brpc_tpu/butil/lockprof.py``) for the NAMED hot locks of the serving
path.

Each named lock (engine slots, per-request emit buffers, batcher queue,
KV store, supervisor state, rpcz collect) is an :class:`InstrumentedLock`
recording, per NAME:

  * acquisitions and CONTENDED acquisitions (an uncontended acquire
    costs one try-acquire beyond the plain lock),
  * the wait of each contended acquisition and the hold of each
    critical section (native ``LatencyRecorder``s: avg, p99, max),
  * the last holder's serving stage (``butil/stagetag.py``).

Stats are shared per name, not per instance: a thousand per-request
emit buffers add up to one "serving.emit_buf" row, so lock churn never
exhausts the native recorder slots.  The recorders are made at a name's
first record, not at construction: importing a module that builds a
lock at module level must not load the native core.

The wrapper satisfies the ``threading.Condition`` lock protocol
(acquire/release/_release_save/_acquire_restore/_is_owned), so a
Condition built over it keeps its semantics while each reacquire after
``wait()`` is accounted like any other acquisition.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback

from . import stagetag

_registry: dict[str, "LockStats"] = {}
_registry_mu = threading.Lock()


class LockStats:
    """The ledger row of one lock name."""

    __slots__ = ("name", "_wait_rec", "_hold_rec", "acquisitions",
                 "contentions", "last_holder_stage")

    def __init__(self, name: str):
        from ..bvar import Adder
        self.name = name
        safe = name.replace(".", "_").replace("-", "_")
        self._wait_rec = None
        self._hold_rec = None
        self.acquisitions = Adder(f"lock_{safe}_acquisitions")
        self.contentions = Adder(f"lock_{safe}_contentions")
        self.last_holder_stage = ""

    def _make_recorders(self) -> None:
        # the native recorders load (and at first use build) the core
        from ..bvar import LatencyRecorder
        with _registry_mu:
            if self._hold_rec is None:
                safe = self.name.replace(".", "_").replace("-", "_")
                self._wait_rec = LatencyRecorder(f"lock_{safe}_wait_us")
                self._hold_rec = LatencyRecorder(f"lock_{safe}_hold_us")

    @property
    def wait_rec(self):
        if self._wait_rec is None:
            self._make_recorders()
        return self._wait_rec

    @property
    def hold_rec(self):
        if self._hold_rec is None:
            self._make_recorders()
        return self._hold_rec

    def snapshot(self) -> dict:
        acq = self.acquisitions.get_value()
        con = self.contentions.get_value()
        return {
            "acquisitions": acq,
            "contentions": con,
            "contention_ratio": round(con / acq, 4) if acq else 0.0,
            "wait_avg_us": round(self.wait_rec.latency(), 1),
            "wait_p99_us": round(self.wait_rec.latency_percentile(0.99), 1),
            "wait_max_us": self.wait_rec.max_latency(),
            "wait_count": self.wait_rec.count(),
            "wait_total_us": self.wait_rec.snapshot()[1],
            "hold_avg_us": round(self.hold_rec.latency(), 1),
            "hold_p99_us": round(self.hold_rec.latency_percentile(0.99), 1),
            "hold_max_us": self.hold_rec.max_latency(),
            "last_holder_stage": self.last_holder_stage,
        }


def lock_stats(name: str) -> LockStats:
    """Get-or-create the shared ledger row of `name`."""
    st = _registry.get(name)
    if st is None:
        with _registry_mu:
            st = _registry.get(name)
            if st is None:
                st = _registry[name] = LockStats(name)
    return st


def locks_snapshot() -> dict[str, dict]:
    """Every ledger row, by lock name."""
    with _registry_mu:
        entries = dict(_registry)
    return {name: st.snapshot() for name, st in sorted(entries.items())}


class InstrumentedLock:
    """A Lock/RLock wrapper feeding the shared ledger entry `name`.

    ``inner`` defaults to a plain ``threading.Lock``; pass
    ``threading.RLock()`` for reentrant use.  Multiple wrapper
    instances may (and for per-request locks, should) share one name.
    """

    __slots__ = ("_inner", "_is_rlock", "stats", "_depth", "_t_hold")

    def __init__(self, name: str, inner=None):
        self._inner = inner if inner is not None else threading.Lock()
        # RLocks carry the Condition protocol natively; plain Locks
        # need our emulation below
        self._is_rlock = hasattr(self._inner, "_is_owned")
        self.stats = lock_stats(name)
        self._depth = 0          # touched only while holding the lock
        self._t_hold = 0.0

    # ---- core protocol ----

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _witness_on:
            # order edges are recorded at acquire ATTEMPT, not success:
            # a genuine ABBA deadlock never completes its second
            # acquire, and the attempt is exactly the evidence we need
            _witness_attempt(self.stats.name)
        if self._inner.acquire(False):
            got = True
        elif not blocking:
            return False
        else:
            st = self.stats
            st.contentions.add(1)
            t0 = time.monotonic()
            if _witness_on:
                _witness_waiting(st.name)
            try:
                got = self._inner.acquire(True, timeout)
            finally:
                if _witness_on:
                    _witness_waiting(None)
            if got:
                st.wait_rec.add(int((time.monotonic() - t0) * 1e6))
        if got:
            self._begin_hold()
        return got

    def release(self) -> None:
        self._end_hold()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else self._depth > 0

    # ---- hold accounting (caller holds the lock at both sites) ----

    def _begin_hold(self) -> None:
        self._depth += 1
        if self._depth == 1:
            self._t_hold = time.monotonic()
            st = self.stats
            st.acquisitions.add(1)
            st.last_holder_stage = stagetag.current_stage()
            if _witness_on:
                _witness_acquired(st.name)

    def _end_hold(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self.stats.hold_rec.add(
                int((time.monotonic() - self._t_hold) * 1e6))
            if _witness_on:
                _witness_released(self.stats.name)

    # ---- threading.Condition protocol ----

    def _release_save(self):
        """Full release (all recursion levels) for Condition.wait."""
        depth, self._depth = self._depth, 1
        self._end_hold()
        if self._is_rlock:
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        st = self.stats
        if _witness_on:
            _witness_attempt(st.name)
        t0 = time.monotonic()
        if self._is_rlock:
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        waited = time.monotonic() - t0
        # a reacquire that had to park behind another holder is real
        # contention; an immediate reacquire is not worth a record
        if waited >= 50e-6:
            st.contentions.add(1)
            st.wait_rec.add(int(waited * 1e6))
        self._begin_hold()
        self._depth = depth

    def _is_owned(self) -> bool:
        if self._is_rlock:
            return self._inner._is_owned()
        # plain-Lock emulation (mirrors threading.Condition's fallback),
        # on the INNER lock so the probe never pollutes the ledger
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return (f"<InstrumentedLock {self.stats.name!r} "
                f"depth={self._depth}>")


# ---------------------------------------------------------------------------
# Runtime lock-order witness
#
# The ledger above answers "which lock is hot"; the witness answers
# "which locks can DEADLOCK".  Every InstrumentedLock acquisition
# records, per thread, the set of named locks already held; the first
# time lock B is acquired while A is held, the ordered edge A->B enters
# a process-global lock-order graph.  A new edge that closes a cycle
# (some path B->...->A already exists) is an ABBA violation: a
# POTENTIAL deadlock, reported the first time the two orders are ever
# observed -- no actual hang is needed.
#
# Cost discipline: the steady-state per-acquisition work is one module
# flag read, one thread-local lookup, a list append/pop and -- only
# while other locks are held -- a dict membership probe per held lock.
# The witness lock (_wit_mu) is taken only when a NEVER-SEEN edge
# appears, which happens a bounded number of times per process
# (distinct name pairs), so the hot path never serializes on it.
#
# The held-set tables are also a wedge dump: ``held_locks_snapshot()``
# shows every thread's held names and, for a thread parked in a
# contended acquire, the name it is waiting for.
# ---------------------------------------------------------------------------

_witness_on = os.environ.get("BRPC_LOCK_WITNESS", "1") not in ("0", "", "off")
_wit_mu = threading.Lock()
_wit_tls = threading.local()
_wit_edges: dict[tuple, dict] = {}        # (a, b) -> {"site", "count"}
_wit_adj: dict[str, set] = {}             # a -> {b, ...}
_wit_violations: list = []
_wit_seen_cycles: set = set()
_wit_threads: dict[int, list] = {}        # ident -> held-name list
_wit_waiting: dict[int, str] = {}         # ident -> name being waited on
_wit_viol_adder = None                    # lazy bvar Adder
MAX_WITNESS_EDGES = 4096
MAX_WITNESS_VIOLATIONS = 64


def set_witness_enabled(on: bool) -> None:
    global _witness_on
    _witness_on = bool(on)


def witness_enabled() -> bool:
    return _witness_on


def _wit_held() -> list:
    held = getattr(_wit_tls, "held", None)
    if held is None:
        held = _wit_tls.held = []
    ident = threading.get_ident()
    # re-register whenever the table lost us — reset_witness() clears
    # it, and a thread whose TLS list predates the reset must come
    # back, or every post-reset wedge dump reads "(none held)".  The
    # steady-state cost is one dict hit.
    if _wit_threads.get(ident) is not held:
        with _wit_mu:
            if len(_wit_threads) > 512:
                alive = {t.ident for t in threading.enumerate()}
                for k in [k for k, v in _wit_threads.items()
                          if not v and k not in alive]:
                    del _wit_threads[k]
            _wit_threads[ident] = held
    return held


def _wit_site() -> str:
    f = sys._getframe(2)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.relpath(f.f_code.co_filename)}:{f.f_lineno}"


def _witness_waiting(name) -> None:
    ident = threading.get_ident()
    if name is None:
        _wit_waiting.pop(ident, None)
    else:
        _wit_waiting[ident] = name


def _witness_attempt(name: str) -> None:
    """Record order edges held->name the first time each is seen."""
    held = _wit_held()
    if held:
        for h in held:
            if h != name and (h, name) not in _wit_edges:
                _wit_new_edge(h, name)


def _witness_acquired(name: str) -> None:
    _wit_held().append(name)


def _witness_released(name: str) -> None:
    held = getattr(_wit_tls, "held", None)
    if held:
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break


def _wit_new_edge(a: str, b: str) -> None:
    """First observation of order a->b: insert, then cycle-check."""
    with _wit_mu:
        if (a, b) in _wit_edges or len(_wit_edges) >= MAX_WITNESS_EDGES:
            return
        site = _wit_site()
        _wit_edges[(a, b)] = {"site": site, "count": 1}
        _wit_adj.setdefault(a, set()).add(b)
        # does a path b -> ... -> a already exist?  (iterative DFS with
        # parent links so the violation report carries the cycle path)
        parent = {b: None}
        stack = [b]
        found = False
        while stack and not found:
            n = stack.pop()
            for m in _wit_adj.get(n, ()):
                if m not in parent:
                    parent[m] = n
                    if m == a:
                        found = True
                        break
                    stack.append(m)
        if not found:
            return
        path = [a]
        n = parent[a]
        while n is not None:
            path.append(n)
            n = parent[n]
        path.reverse()               # b ... a
        cycle = path + [b]           # b ... a -> b closes it
        key = frozenset(cycle)
        if key in _wit_seen_cycles:
            return
        _wit_seen_cycles.add(key)
        if len(_wit_violations) >= MAX_WITNESS_VIOLATIONS:
            return
        edge_sites = {
            f"{x}->{y}": _wit_edges.get((x, y), {}).get("site", "?")
            for x, y in zip(cycle, cycle[1:])}
        _wit_violations.append({
            "cycle": cycle,
            "edge": [a, b],
            "site": site,
            "thread": threading.current_thread().name,
            "stage": stagetag.current_stage(),
            "edge_sites": edge_sites,
            "stack": "".join(traceback.format_stack(
                sys._getframe(1), limit=12)),
        })
    global _wit_viol_adder
    try:
        if _wit_viol_adder is None:
            from ..bvar import Adder
            _wit_viol_adder = Adder("lock_order_violations")
        _wit_viol_adder.add(1)
    except Exception:
        pass


def held_locks_snapshot() -> dict:
    """Every tracked thread's held named locks (+ the lock it is
    blocked acquiring, when contended) -- the wedge dump's payload."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    with _wit_mu:
        rows = [(i, list(h)) for i, h in _wit_threads.items()]
    waiting = dict(_wit_waiting)
    for ident, held in rows:
        wait = waiting.get(ident)
        if not held and wait is None:
            continue
        label = names.get(ident, f"thread-{ident}")
        out[label] = {"held": held, "waiting_for": wait}
    return out


def lock_order_edges() -> dict:
    """The observed order graph: {'a->b': {'site': ..}} (the
    ``/hotspots/locks?fmt=json`` witness section)."""
    with _wit_mu:
        return {f"{a}->{b}": dict(info)
                for (a, b), info in sorted(_wit_edges.items())}


def order_violations() -> list:
    """ABBA cycles observed so far (potential deadlocks)."""
    with _wit_mu:
        return [dict(v) for v in _wit_violations]


def reset_witness() -> None:
    """Drop the graph, violations and held-set tables (tests)."""
    with _wit_mu:
        _wit_edges.clear()
        _wit_adj.clear()
        _wit_violations.clear()
        _wit_seen_cycles.clear()
        _wit_threads.clear()
    _wit_waiting.clear()
    _wit_tls.held = []


def witness_report() -> str:
    """Human-readable dump: held sets per thread, the order graph's
    size, and every ABBA cycle with its edge sites."""
    lines = ["--- lock-order witness ---"]
    snap = held_locks_snapshot()
    if snap:
        lines.append("held locks by thread:")
        for tname, row in sorted(snap.items()):
            wait = (f"  (BLOCKED acquiring {row['waiting_for']!r})"
                    if row["waiting_for"] else "")
            lines.append(f"  {tname}: {row['held'] or '[]'}{wait}")
    else:
        lines.append("held locks by thread: (none held)")
    with _wit_mu:
        n_edges = len(_wit_edges)
        viols = [dict(v) for v in _wit_violations]
    lines.append(f"order graph: {n_edges} edge(s)")
    if viols:
        lines.append(f"ABBA violations: {len(viols)}")
        for v in viols:
            lines.append("  cycle: " + " -> ".join(v["cycle"]))
            for edge, site in sorted(v["edge_sites"].items()):
                lines.append(f"    {edge} first seen at {site}")
            lines.append(f"    closing thread: {v['thread']} "
                         f"(stage {v['stage'] or '-'})")
    else:
        lines.append("ABBA violations: none")
    return "\n".join(lines) + "\n"
