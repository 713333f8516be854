"""The ``_telemetry`` service and the router-side ``FleetCollector``:
the fleet telemetry plane (a copy of ``brpc_tpu/serving/telemetry.py``).

``/vars`` and ``/rpcz`` answer for one process; this module collects
them across the fleet:

  * :class:`TelemetryService` (``_telemetry``) registers in every
    serving process -- replica, PS shard, router -- and answers two
    pulls on tensorframe RPCs:

      ``Pull {cursor, max_spans, max_vars, filter}`` -> a bounded
          snapshot of named bvars (Adder/PassiveStatus scalars,
          LatencyRecorder summaries, ``bvar/window.py`` windowed
          values), the flight recorder's syscall counters (write
          syscalls, the bytes-per-write histogram), and every FINISHED
          rpcz span whose collection seq is past ``cursor``
          (:func:`brpc_tpu_torch.rpcz.spans_since`);

      ``Trace {trace_id}`` -> every collected span of ONE trace.

    Payloads ride as inline JSON str fields on the tensorframe reply
    (1 MiB cap a field; the bounds above keep replies far under it).

  * :class:`FleetCollector` lives on the router: one ``Pull`` per
    endpoint per pull interval over the router's short-timeout control
    channel (the ``_cluster`` SetFloor transport: a dead replica costs
    the control timeout, never the data plane's forward timeout),
    merged into time-series rings keyed ``(replica, model, metric)``.
    A dead replica is TOMBSTONED after consecutive pull failures: its
    series freeze and drop out of every cross-replica aggregate.  The
    collector's pulls and pulled bytes are bvars.

The rings are plain deques of ``(t, value)``, not LatencyRecorders: the
native recorder pool has 512 slots a process, and replicas x models x
metrics would exhaust it.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable, Optional

from .. import errors, rpcz
from ..butil.lockprof import InstrumentedLock
from ..rpc.service import Service, method

TELEMETRY_SERVICE = "_telemetry"

# bounds on one Pull reply (each JSON field must stay far under the
# 1 MiB tensorframe str-field cap)
MAX_VARS = 2048
MAX_SPANS = 512


def telemetry_snapshot(max_vars: int = 512,
                       pattern: str = "*") -> dict:
    """The bounded bvar snapshot one ``Pull`` ships: scalar variables
    (Adders, PassiveStatus, gauges), LatencyRecorder summaries, and
    ``bvar/window.py`` windowed series values, each name counted once
    against ``max_vars`` (alphabetical, so truncation is deterministic);
    plus the flight recorder's syscall counters."""
    from ..butil import flight
    from ..bvar.recorder import LatencyRecorder
    from ..bvar.variable import exposed_variables
    from ..bvar.window import Window

    scalars: dict[str, float] = {}
    recorders: dict[str, dict] = {}
    windows: dict[str, dict] = {}
    truncated = False
    n = 0
    for name, var in sorted(exposed_variables(pattern).items()):
        if n >= max_vars:
            truncated = True
            break
        try:
            if isinstance(var, LatencyRecorder):
                c, s_us, m = var.snapshot()
                recorders[name] = {
                    "count": c,
                    "avg_us": round(var.latency(), 1),
                    "p50_us": round(var.latency_percentile(0.5), 1),
                    "p99_us": round(var.latency_percentile(0.99), 1),
                    "max_us": m,
                    "qps": round(var.qps(), 2),
                }
            elif isinstance(var, Window):
                windows[name] = {"value": var.get_value(),
                                 "window_s": var._window}
            else:
                v = var.get_value()
                if isinstance(v, bool):
                    v = int(v)
                if not isinstance(v, (int, float)):
                    continue   # non-numeric: not a series, not counted
                scalars[name] = v
        except Exception:
            continue   # one torn-down variable must not kill the pull
        n += 1
    return {
        "scalars": scalars,
        "recorders": recorders,
        "windows": windows,
        "syscalls": flight.syscall_counters(),
        "bytes_per_write": {k: v for k, v in
                            flight.write_size_hist().items() if v},
        "truncated": truncated,
    }


class TelemetryService(Service):
    """Per-process half of the fleet telemetry plane (see module
    docstring): incremental bvar/span pulls plus the on-demand
    one-trace read the router's rpcz fan-out issues."""

    NAME = TELEMETRY_SERVICE

    def __init__(self, *, name: str = ""):
        self.name = str(name)
        self.pulls = 0
        self.trace_queries = 0

    @method(request="tensorframe", response="tensorframe")
    def Pull(self, cntl, req):
        req = req or {}
        cursor = max(0, int(req.get("cursor", 0)))
        max_spans = min(MAX_SPANS, max(0, int(req.get("max_spans", 256))))
        max_vars = min(MAX_VARS, max(0, int(req.get("max_vars", 512))))
        pattern = str(req.get("filter") or "*")
        spans, hi = rpcz.spans_since(cursor, max_spans)
        self.pulls += 1
        return {
            "name": self.name,
            "pid": int(os.getpid()),
            "cursor": int(hi),
            "vars": json.dumps(telemetry_snapshot(max_vars, pattern),
                               separators=(",", ":")),
            "spans": json.dumps([rpcz.span_to_dict(s) for s in spans],
                                separators=(",", ":")),
        }

    @method(request="tensorframe", response="tensorframe")
    def Trace(self, cntl, req):
        req = req or {}
        try:
            tid = int(req.get("trace_id", 0))
        except (TypeError, ValueError):
            tid = 0
        if not tid:
            cntl.set_failed(errors.EREQUEST, 'missing "trace_id"')
            return None
        spans = rpcz.recent_spans(2048, tid)
        if not spans:
            spans = rpcz.load_disk_spans(2048, tid)
        self.trace_queries += 1
        return {
            "name": self.name,
            "pid": int(os.getpid()),
            "spans": json.dumps([rpcz.span_to_dict(s) for s in spans],
                                separators=(",", ":")),
        }

    def stats(self) -> dict:
        return {"pulls": self.pulls, "trace_queries": self.trace_queries}


def register_telemetry(server, *, name: str = "") -> TelemetryService:
    """Expose this process to the fleet telemetry plane (call before
    ``server.start()``)."""
    svc = TelemetryService(name=name)
    server.add_service(svc)
    return svc


def parse_spans_field(field) -> list:
    """Decode a ``spans`` reply field into Span objects, dropping any
    malformed record (one bad span from a remote process must not kill
    the merge)."""
    if not field:
        return []
    try:
        recs = json.loads(field)
    except (TypeError, ValueError):
        return []
    if not isinstance(recs, list):
        return []
    out = []
    for rec in recs:
        s = rpcz.span_from_dict(rec)
        if s is not None:
            out.append(s)
    return out


class FleetCollector:
    """Router-side aggregation (see module docstring): per-endpoint
    incremental pulls into fleet series rings, a bounded fleet span
    store for cross-process trace stitching, and the tombstone ledger
    the SLO engine's disruption HOLD reads."""

    RING = 128            # samples per (replica, model, metric) series
    SPAN_KEEP = 4096      # fleet span store bound
    TOMBSTONE_AFTER = 2   # consecutive failed pulls before tombstoning
    FANOUT_MAX_ADDRS = 16

    def __init__(self, name: str = "fleet", *,
                 control_timeout_ms: int = 1000,
                 var_filter: str = "*"):
        from ..bvar.reducer import Adder
        self.name = str(name)
        self.control_timeout_ms = int(control_timeout_ms)
        # glob over remote var names: a collector that only needs a
        # few series shouldn't make every replica snapshot (and both
        # sides JSON-codec) its whole namespace each pull
        self.var_filter = str(var_filter or "*")
        self._mu = InstrumentedLock("fleet.collector")
        # (replica, model, metric) -> deque[(t, value)]
        self._series: dict[tuple, deque] = {}
        # endpoint key -> replica state
        self._replicas: dict[str, dict] = {}
        # fleet span store: dedupe key -> Span, bounded FIFO
        self._spans: dict[tuple, object] = {}
        self._span_order: deque = deque()
        self._chan_by_addr: dict[str, object] = {}
        safe = self.name.replace(".", "_").replace("-", "_")
        self._bvar_names = [f"fleet_{safe}_pulls",
                            f"fleet_{safe}_pull_bytes",
                            f"fleet_{safe}_pull_errors",
                            f"fleet_{safe}_tombstones"]
        self.pulls = Adder(self._bvar_names[0])
        self.pull_bytes = Adder(self._bvar_names[1])
        self.pull_errors = Adder(self._bvar_names[2])
        self.tombstones = Adder(self._bvar_names[3])

    # ---- series rings -------------------------------------------------

    def _append(self, replica: str, model: str, metric: str,
                t: float, value: float) -> None:
        key = (str(replica), str(model), str(metric))
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = deque(maxlen=self.RING)
        ring.append((t, float(value)))

    def window_values(self, replica: str, model: str, metric: str,
                      window_s: float,
                      now: Optional[float] = None) -> list[float]:
        """Samples of one series within the trailing window."""
        now = time.monotonic() if now is None else now
        with self._mu:
            ring = self._series.get((str(replica), str(model),
                                     str(metric)))
            if not ring:
                return []
            return [v for (t, v) in ring if t >= now - window_s]

    def values_across(self, model: str, metric: str, window_s: float,
                      now: Optional[float] = None) -> list[float]:
        """Windowed samples of one (model, metric) across every
        NON-TOMBSTONED replica — the cross-replica aggregate the SLO
        engine evaluates.  A tombstoned replica's series is excluded
        entirely (frozen, never averaged) rather than padded."""
        now = time.monotonic() if now is None else now
        out: list[float] = []
        with self._mu:
            dead = {a for a, st in self._replicas.items()
                    if st.get("tombstoned")}
            for (rep, mod, met), ring in self._series.items():
                if mod != str(model) or met != str(metric):
                    continue
                if rep in dead:
                    continue
                out.extend(v for (t, v) in ring if t >= now - window_s)
        return out

    # ---- pulls --------------------------------------------------------

    def _state(self, addr: str) -> dict:
        st = self._replicas.get(addr)
        if st is None:
            st = self._replicas[addr] = {
                "addr": addr, "name": "", "pid": None, "cursor": 0,
                "pulls": 0, "errors": 0, "consec_errors": 0,
                "unsupported": False, "tombstoned": False,
                "tombstone_t": None, "recover_t": None,
                "last_pull_t": None, "last_bytes": 0}
        return st

    def pull(self, addr: str, channel, *, model_hint: str = "") -> bool:
        """One incremental ``Pull`` from ``addr`` over ``channel`` (the
        router's control channel — the SetFloor transport).  Returns
        True on success.  Failures count toward the tombstone; an
        ENOSERVICE/ENOMETHOD reply (process without the service)
        disables further pulls without tombstoning — absence of
        telemetry is not death."""
        with self._mu:
            st = self._state(addr)
            if st["unsupported"]:
                return False
            cursor = st["cursor"]
        try:
            resp = channel.call_sync(
                TELEMETRY_SERVICE, "Pull",
                {"cursor": int(cursor), "max_spans": 256,
                 "max_vars": MAX_VARS, "filter": self.var_filter},
                serializer="tensorframe",
                response_serializer="tensorframe")
        except errors.RpcError as e:
            with self._mu:
                st = self._state(addr)
                if e.code in (errors.ENOSERVICE, errors.ENOMETHOD):
                    st["unsupported"] = True
                    return False
                st["errors"] += 1
                st["consec_errors"] += 1
                self.pull_errors.add(1)
                if (not st["tombstoned"]
                        and st["consec_errors"] >= self.TOMBSTONE_AFTER):
                    st["tombstoned"] = True
                    st["tombstone_t"] = time.monotonic()
                    self.tombstones.add(1)
            return False
        now = time.monotonic()
        resp = resp or {}
        vars_field = resp.get("vars") or ""
        spans_field = resp.get("spans") or ""
        nbytes = len(vars_field) + len(spans_field)
        try:
            snap = json.loads(vars_field) if vars_field else {}
        except (TypeError, ValueError):
            snap = {}
        spans = parse_spans_field(spans_field)
        with self._mu:
            st = self._state(addr)
            if st["tombstoned"]:
                st["tombstoned"] = False
                st["recover_t"] = now
            st["consec_errors"] = 0
            st["pulls"] += 1
            st["cursor"] = max(st["cursor"],
                               int(resp.get("cursor", st["cursor"])))
            st["name"] = str(resp.get("name") or st["name"])
            st["pid"] = resp.get("pid", st["pid"])
            st["last_pull_t"] = now
            st["last_bytes"] = nbytes
            st["snapshot"] = snap
            # recorder p99/qps and windowed values become fleet series;
            # scalar counters stay in the last-snapshot table (/fleet)
            for nm, rec in (snap.get("recorders") or {}).items():
                try:
                    self._append(addr, model_hint, f"{nm}.p99_us",
                                 now, rec["p99_us"])
                    self._append(addr, model_hint, f"{nm}.qps",
                                 now, rec["qps"])
                except (KeyError, TypeError, ValueError):
                    continue
            for nm, win in (snap.get("windows") or {}).items():
                try:
                    self._append(addr, model_hint, nm, now,
                                 float(win["value"]))
                except (KeyError, TypeError, ValueError):
                    continue
            self._merge_spans_locked(spans)
        self.pulls.add(1)
        self.pull_bytes.add(nbytes)
        return True

    def note_dead(self, addr: str) -> None:
        """Tombstone ``addr`` immediately (the router already knows the
        replica is gone — no need to burn TOMBSTONE_AFTER pulls)."""
        with self._mu:
            st = self._state(addr)
            if not st["tombstoned"]:
                st["tombstoned"] = True
                st["tombstone_t"] = time.monotonic()
                self.tombstones.add(1)

    def sample_models(self, model_metrics, *,
                      replica: str = "router") -> None:
        """Sample the router-local per-(model, version) scoreboard
        (:class:`~brpc_tpu_torch.serving.modelplane.ModelMetrics`) into fleet
        series — TTFT/ITL percentiles live on the ROUTER (it observes
        every stream), so these are the series the SLO engine burns
        against, keyed replica=\"router\"."""
        now = time.monotonic()
        snap = model_metrics.snapshot()
        with self._mu:
            for model, row in snap.items():
                ttft = (row.get("ttft") or {}).get("p99_ms")
                itl = (row.get("itl") or {}).get("p99_ms")
                if ttft is not None:
                    self._append(replica, model, "ttft_p99_ms", now, ttft)
                if itl is not None:
                    self._append(replica, model, "itl_p99_ms", now, itl)
                self._append(replica, model, "finished", now,
                             row.get("finished", 0))
                self._append(replica, model, "failed", now,
                             row.get("failed", 0))

    # ---- disruption window (the SLO HOLD input) -----------------------

    def tombstoned(self) -> list[str]:
        with self._mu:
            return sorted(a for a, st in self._replicas.items()
                          if st.get("tombstoned"))

    def disruption_within(self, window_s: float,
                          now: Optional[float] = None) -> bool:
        """True while any replica is tombstoned, or was tombstoned or
        recovered within the trailing window — the SLO engine HOLDs
        canary decisions inside this window (chaos-induced burn must
        not promote or roll back)."""
        now = time.monotonic() if now is None else now
        with self._mu:
            for st in self._replicas.values():
                if st.get("tombstoned"):
                    return True
                for k in ("tombstone_t", "recover_t"):
                    t = st.get(k)
                    if t is not None and now - t <= window_s:
                        return True
        return False

    # ---- fleet span store / trace stitching ---------------------------

    def _merge_spans_locked(self, spans) -> None:
        for s in spans:
            key = (s.trace_id, s.span_id, s.kind, s.start_us)
            if key in self._spans:
                continue
            self._spans[key] = s
            self._span_order.append(key)
            while len(self._span_order) > self.SPAN_KEEP:
                old = self._span_order.popleft()
                self._spans.pop(old, None)

    def merge_spans(self, spans) -> None:
        with self._mu:
            self._merge_spans_locked(spans)

    def fleet_spans(self, trace_id: int) -> list:
        with self._mu:
            return [s for s in self._spans.values()
                    if s.trace_id == trace_id]

    def _channel(self, addr: str):
        ch = self._chan_by_addr.get(addr)
        if ch is None:
            from ..rpc.channel import control_channel
            ch = control_channel(addr, self.control_timeout_ms)
            self._chan_by_addr[addr] = ch
        return ch

    def fan_out_trace(self, trace_id: int,
                      addrs: Optional[list] = None) -> list:
        """The on-demand cross-process read behind ``/rpcz?trace_id=``
        on the router: merge (1) this process's collected/persisted
        spans, (2) the fleet span store, and (3) a live ``Trace`` query
        to every known endpoint PLUS every address discovered in
        already-merged client spans' ``remote_side`` — that second hop
        is how the PS shard the router never talks to directly joins
        the tree (the replica's client span names it).  Bounded to
        FANOUT_MAX_ADDRS queried addresses, each on a short-timeout
        control channel; a dead or telemetry-less process simply
        contributes nothing."""
        trace_id = int(trace_id)
        merged: dict[tuple, object] = {}

        def fold(spans) -> None:
            for s in spans:
                merged.setdefault(
                    (s.trace_id, s.span_id, s.kind, s.start_us), s)

        fold(rpcz.recent_spans(2048, trace_id))
        fold(rpcz.load_disk_spans(2048, trace_id))
        fold(self.fleet_spans(trace_id))
        with self._mu:
            known = [a for a, st in self._replicas.items()
                     if not st.get("unsupported")
                     and not st.get("tombstoned")]
        pending = list(addrs or ()) + known
        queried: set[str] = set()
        while pending and len(queried) < self.FANOUT_MAX_ADDRS:
            addr = str(pending.pop(0))
            if not addr or addr in queried:
                continue
            queried.add(addr)
            try:
                resp = self._channel(addr).call_sync(
                    TELEMETRY_SERVICE, "Trace",
                    {"trace_id": trace_id},
                    serializer="tensorframe",
                    response_serializer="tensorframe")
            except errors.RpcError:
                continue
            spans = parse_spans_field((resp or {}).get("spans"))
            fold(spans)
            # follow callee addresses the new spans name: the replica's
            # client span's remote_side is the PS shard's server
            for s in spans:
                peer = str(s.remote_side or "")
                if peer and peer not in queried:
                    pending.append(peer)
        out = list(merged.values())
        self.merge_spans(out)
        return out

    # ---- introspection ------------------------------------------------

    def series_snapshot(self, points: int = 32) -> dict:
        """Nested ``replica -> model -> metric -> [values...]`` view of
        the rings (last ``points`` samples) — the /fleet sparkline
        data."""
        out: dict = {}
        with self._mu:
            for (rep, mod, met), ring in sorted(self._series.items()):
                vals = [round(v, 4) for (_t, v) in list(ring)[-points:]]
                out.setdefault(rep, {}).setdefault(
                    mod or "-", {})[met] = vals
        return out

    def replica_table(self) -> list[dict]:
        now = time.monotonic()
        out = []
        with self._mu:
            for addr, st in sorted(self._replicas.items()):
                row = {k: st.get(k) for k in
                       ("addr", "name", "pid", "cursor", "pulls",
                        "errors", "consec_errors", "unsupported",
                        "tombstoned", "last_bytes")}
                row["pull_age_s"] = (
                    round(now - st["last_pull_t"], 3)
                    if st.get("last_pull_t") else None)
                syscalls = (st.get("snapshot") or {}).get("syscalls")
                if syscalls:
                    row["syscalls"] = syscalls
                out.append(row)
        return out

    def last_snapshot(self, addr: str) -> Optional[dict]:
        with self._mu:
            st = self._replicas.get(str(addr))
            return (st or {}).get("snapshot")

    def stats(self) -> dict:
        with self._mu:
            nseries = len(self._series)
            nspans = len(self._spans)
        return {
            "pulls": self.pulls.get_value(),
            "pull_bytes": self.pull_bytes.get_value(),
            "pull_errors": self.pull_errors.get_value(),
            "tombstones": self.tombstones.get_value(),
            "series": nseries,
            "fleet_spans": nspans,
            "replicas": self.replica_table(),
        }

    def close(self) -> None:
        from ..bvar.variable import find_exposed
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()


__all__ = [
    "TELEMETRY_SERVICE", "TelemetryService", "register_telemetry",
    "telemetry_snapshot", "parse_spans_field", "FleetCollector",
]
