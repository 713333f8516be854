"""Builtin console pages (a copy of ``brpc_tpu/builtin/services.py``).

``build_routes(server)`` returns the reference's route table, key for
key.  Served: ``/``, ``/index``, ``/dashboard`` (per-method qps and
latency sparklines), ``/status`` (per-method counts and latency from
``MethodStatus``), ``/vars`` (``?filter=`` wildcard), ``/flags`` (live
edit with ``?setvalue=``), ``/health``, ``/version``, ``/connections``,
``/sockets``, ``/bthreads`` (the native executor's counters), ``/rpcz``
(recent spans; ``?trace_id=`` the tree-ordered timeline of one trace,
from the span database when the in-memory store lost it),
``/brpc_metrics`` (Prometheus text), ``/services`` and ``/protobufs``
(method inventory), ``/memory``, ``/serving``,
``/serving/generations``, ``/kvcache``, ``/psserve``, ``/migration``,
``/hotspots`` (the always-on stage-tagged sampler's ring;
``?seconds=N`` a 100 Hz burst, ``?fmt=collapsed|pb``),
``/hotspots/locks`` (the lock ledger and the lock-order witness),
``/flightrecorder`` (the native flight recorder: the per-thread table,
the merged event tail and the syscall counters; ``?limit=N``,
``?fmt=json``), ``/vlog`` and ``/dir`` (off unless
``enable_dir_service``).

The pages whose module the port has not ported yet answer 501 and name
the ROADMAP item that brings them: ``/ici`` (Queue 1 item 8),
``/fleet`` (item 7, second half), the on-demand profilers
``/hotspots/{cpu,native,contention,heap,growth}`` and ``/pprof/*``
(``builtin/profiler.py``).  A page whose data source raises answers 500
with the traceback (the router's rule).
"""
from __future__ import annotations

import html
import json
import sys
import threading
import time

from .. import rpcz
from .._core import lib as _lib
from ..bvar import dump_exposed
from ..flags import define_flag, get_flag, list_flags, set_flag
from .router import http_response

# filesystem browsing is an explicit operator opt-in, and NOT
# reloadable: a live-flippable gate would let anyone with console
# access turn on arbitrary-file reads through /flags
define_flag("enable_dir_service", False,
            "allow /dir to browse the server's filesystem (start-time only)",
            reloadable=False)

_PKG = __name__.rsplit(".", 2)[0]    # "brpc_tpu_torch"
SERVER_INFO_NAME = "tpu-rpc"          # the JAX package's default name


def _not_ported(what: str):
    """A route whose module the port lacks: 501, naming what brings it."""
    def page(req):
        return http_response(
            501, f"{req.path}: not ported yet; it comes with {what} "
                 f"(ROADMAP.md)\n")
    return page


def build_routes(server) -> dict:
    core = _lib.load()[0]

    def index(req):
        rows = "".join(
            f'<li><a href="{p}">{p}</a></li>'
            for p in sorted(routes) if p not in ("/", "/index"))
        return (f"<html><head><title>{SERVER_INFO_NAME}"
                f"</title></head><body><h1>"
                f"{SERVER_INFO_NAME}</h1>"
                f"<p>uptime {server.uptime_s:.0f}s · port {server.port} · "
                f"{server.connection_count} connections · "
                f'<a href="/dashboard">dashboard</a></p>'
                f"<ul>{rows}</ul></body></html>", "text/html")

    hist = _dash_history_for(server)

    def dashboard(req):
        hist.ensure()
        samples = list(hist.samples)
        blocks = []
        for key, st in sorted(server.method_statuses.items()):
            svc, m = key
            qps, lat = [], []
            for (t0, s0), (t1, s1) in zip(samples, samples[1:]):
                c0, sum0 = s0.get(key, (0, 0))
                c1, sum1 = s1.get(key, (0, 0))
                dt = max(1e-6, t1 - t0)
                dc = max(0, c1 - c0)
                qps.append(dc / dt)
                lat.append((sum1 - sum0) / dc if dc else 0.0)
            r = st.latency_rec
            blocks.append(
                f"<tr><td>{svc}.{m}</td>"
                f"<td>{r.qps():.1f}</td>"
                f"<td>{_spark(qps)}</td>"
                f"<td>{r.latency():.0f}us / "
                f"p99 {r.latency_percentile(0.99):.0f}us</td>"
                f"<td>{_spark(lat)}</td>"
                f"<td>{st.nerror.get_value()}</td></tr>")
        note = ("" if len(samples) > 2 else
                "<p>(collecting history — refresh in a few seconds)</p>")
        return (f"<html><head><title>dashboard</title>"
                f"<meta http-equiv='refresh' content='5'></head><body>"
                f"<h1>{SERVER_INFO_NAME} dashboard</h1>"
                f"<p>last {len(samples)}s · auto-refreshes</p>{note}"
                f"<table border='0' cellpadding='4'>"
                f"<tr><th>method</th><th>qps</th><th>qps (2m)</th>"
                f"<th>latency</th><th>avg latency (2m)</th>"
                f"<th>errors</th></tr>"
                f"{''.join(blocks)}</table></body></html>", "text/html")

    def status(req):
        lines = [f"server: {SERVER_INFO_NAME}",
                 f"uptime_s: {server.uptime_s:.0f}",
                 f"port: {server.port}",
                 f"connections: {server.connection_count}", ""]
        for (svc, m), st in sorted(server.method_statuses.items()):
            r = st.latency_rec
            lines.append(
                f"{svc}.{m}: count={r.count()} error={st.nerror.get_value()} "
                f"qps={r.qps():.1f} concurrency={st.concurrency} "
                f"latency_avg_us={r.latency():.0f} "
                f"p99_us={r.latency_percentile(0.99):.0f} "
                f"max_us={r.max_latency()}")
        return "\n".join(lines) + "\n"

    def vars_page(req):
        pattern = req.query.get("filter", "*")
        data = dump_exposed(pattern)
        return "".join(f"{k} : {_fmt(v)}\n" for k, v in sorted(data.items()))

    def flags_page(req):
        name = req.query.get("setvalue")
        if name is not None:
            val = req.query.get(name, req.query.get("value", ""))
            ok = set_flag(name, val)
            _apply_flag_side_effects(name)
            return ("ok\n" if ok else
                    http_response(400, f"cannot set flag {name!r}\n"))
        out = []
        for f in list_flags():
            mark = " (R)" if f.reloadable else ""
            out.append(f"{f.name}={f.value}{mark}  # {f.help} "
                       f"(default {f.default})")
        return "\n".join(out) + "\n"

    def health(req):
        return ("OK\n" if server.running else
                http_response(500, "server stopping\n"))

    def version(req):
        from .. import __version__
        return f"tpu-rpc/{__version__}\n"

    def connections(req):
        from ..rpc.transport import Transport
        t = Transport.instance()
        lines = [f"{'socket_id':>12} {'remote':>22} {'read':>12} "
                 f"{'written':>12} {'msgs':>8}"]
        for sid in server.connections():
            s = t.socket_stats(sid)
            if s:
                lines.append(f"{sid:>12} {s['remote']:>22} "
                             f"{s['bytes_read']:>12} {s['bytes_written']:>12} "
                             f"{s['messages_read']:>8}")
        return "\n".join(lines) + "\n"

    def sockets(req):
        return (f"active_sockets: {core.brpc_socket_active_count()}\n"
                f"live_iobuf_blocks: {core.brpc_iobuf_live_blocks()}\n")

    def bthreads(req):
        import ctypes
        w = ctypes.c_int64()
        k = ctypes.c_int64()
        t = ctypes.c_int64()
        m = ctypes.c_int64()
        core.brpc_fiber_counters(ctypes.byref(w), ctypes.byref(k),
                                 ctypes.byref(t), ctypes.byref(m))
        return (f"workers: {core.brpc_executor_num_workers()}\n"
                f"tasks_executed: {core.brpc_executor_tasks_executed()}\n"
                f"steals: {core.brpc_executor_steals()}\n"
                f"timers_fired: {core.brpc_timer_fired()}\n"
                f"butex_waits: {w.value}\n"
                f"butex_wakes: {k.value}\n"
                f"butex_timeouts: {t.value}\n"
                f"fiber_mutex_contended: {m.value}\n")

    def rpcz_page(req):
        tid = req.query.get("trace_id")
        limit = int(req.query.get("limit", "50"))
        if tid:
            # the timeline of ONE trace, tree-ordered with relative
            # offsets; the span database when the in-memory store lost
            # it (the fleet's cross-process stitching waits for item 7, second half)
            spans = rpcz.recent_spans(2048, int(tid))
            if not spans:
                spans = rpcz.load_disk_spans(2048, int(tid))
            if not spans:
                return f"no spans collected for trace {tid}\n"
            return rpcz.format_trace(spans)
        spans = rpcz.recent_spans(limit)
        lines = []
        for s in reversed(spans):
            lines.append(
                f"{time.strftime('%H:%M:%S', time.localtime(s.start_us/1e6))}"
                f" trace={s.trace_id} span={s.span_id} "
                f"parent={s.parent_span_id} {s.kind} "
                f"{s.service}.{s.method} peer={s.remote_side} "
                f"lat={s.latency_us}us req={s.request_size}B "
                f"res={s.response_size}B err={s.error_code}"
                + (f" recovered_from={s.recovered_from}"
                   if getattr(s, "recovered_from", 0) else "")
                + (f" migrated_from={s.migrated_from}"
                   if getattr(s, "migrated_from", 0) else "")
                + ("".join(f"\n    @{t} {html.escape(m)}"
                           for t, m in s.annotations)))
        lines.append("")
        lines.append("(append ?trace_id=<id> for the tree-ordered "
                     "timeline of one trace)")
        return "\n".join(lines) + "\n"

    def metrics(req):
        # Prometheus text: LatencyRecorders as quantile-labelled summary
        # families, Adders as counters, the rest as gauges, every family
        # with a # HELP line; MultiDimension variables with their label
        # names.  (The fleet families wait for item 7, second half.)
        from ..bvar.multi_dimension import MultiDimension
        from ..bvar.recorder import IntRecorder, LatencyRecorder
        from ..bvar.reducer import Adder, PassiveStatus
        from ..bvar.variable import exposed_variables

        def esc(v):
            return (str(v).replace("\\", "\\\\")
                    .replace('"', '\\"').replace("\n", "\\n"))

        def mangle(k):
            return k.replace("-", "_").replace(".", "_").replace("/", "_")

        all_vars = sorted(exposed_variables("*").items())
        # a recorder registers <base>_latency (itself) plus satellite
        # percentile and count gauges; the summary family subsumes them
        recorders = {}
        suppress = set()
        for k, var in all_vars:
            if isinstance(var, LatencyRecorder) and k.endswith("_latency"):
                base = k[: -len("_latency")]
                recorders[base] = var
                suppress.add(k)
                suppress.add(base + "_count")
                for q in ("50", "90", "99", "999", "9999"):
                    suppress.add(f"{base}_latency_{q}")
        out = []
        for base, rec in sorted(recorders.items()):
            name = mangle(base)
            try:
                c, s, _m = rec.snapshot()
                quants = [(q, rec.latency_percentile(q))
                          for q in (0.5, 0.9, 0.99, 0.999)]
            except Exception:
                continue
            out.append(f"# HELP {name} latency recorder (microseconds)")
            out.append(f"# TYPE {name} summary")
            for q, v in quants:
                out.append(f'{name}{{quantile="{q}"}} {v}')
            out.append(f"{name}_sum {s}")
            out.append(f"{name}_count {c}")
        for k, var in all_vars:
            if k in suppress:
                continue
            name = mangle(k)
            try:
                if isinstance(var, MultiDimension):
                    out.append(f"# HELP {name} bvar MultiDimension")
                    out.append(f"# TYPE {name} gauge")
                    for key, lvar in var.items():
                        lv = lvar.get_value()
                        if isinstance(lv, bool):
                            lv = int(lv)
                        if not isinstance(lv, (int, float)):
                            continue
                        pairs = ",".join(
                            f'{ln}="{esc(kv)}"'
                            for ln, kv in zip(var.labels, key))
                        out.append(f"{name}{{{pairs}}} {lv}")
                    continue
                v = var.get_value()
            except Exception:
                # one throwing variable must not 500 the whole scrape
                continue
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                if isinstance(var, Adder):
                    kind, what = "counter", "monotonic event counter"
                elif isinstance(var, IntRecorder):
                    kind, what = "gauge", "average of recorded values"
                elif isinstance(var, PassiveStatus):
                    kind, what = "gauge", "pull-callback status"
                else:
                    kind, what = "gauge", type(var).__name__
                out.append(f"# HELP {name} bvar {what}")
                out.append(f"# TYPE {name} {kind}")
                out.append(f"{name} {v}")
        return "\n".join(out) + "\n", "text/plain; version=0.0.4"

    def services_page(req):
        out = {}
        for name, svc in server.services.items():
            out[name] = {m: {
                "request": spec.request_serializer.name,
                "response": spec.response_serializer.name,
            } for m, spec in svc.rpc_methods().items()}
        return json.dumps(out, indent=1), "application/json"

    def memory(req):
        import ctypes
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        buf = ctypes.create_string_buffer(1 << 18)
        n = core.brpc_iobuf_alloc_folded(buf, len(buf))
        sites = buf.value.decode("utf-8", "replace") if n > 0 else ""
        return (f"max_rss_kb: {ru.ru_maxrss}\n"
                f"live_iobuf_blocks: {core.brpc_iobuf_live_blocks()}\n"
                f"iobuf_block_handouts: {core.brpc_iobuf_alloc_events()}\n"
                f"\n--- iobuf block allocation sites (sampled 1/ms; "
                f"addr2line -e libbrpc_core_torch.so <offset> for local "
                f"frames) ---\n{sites}")

    # the serving, kvcache, psserve and migration pages import their
    # layer lazily: it loads only when something registered a
    # component there
    def serving_page(req):
        if f"{_PKG}.serving" not in sys.modules:
            return "no serving components registered\n"
        from ..serving import serving_snapshot
        snap = serving_snapshot()
        if not snap["batchers"] and not snap["engines"] \
                and not snap["supervisors"]:
            return "no serving components registered\n"
        return json.dumps(snap, indent=1), "application/json"

    def serving_generations_page(req):
        if f"{_PKG}.serving" not in sys.modules:
            return "no serving components registered\n"
        from ..serving import generations_snapshot
        limit = int(req.query.get("limit", "50"))
        return json.dumps(generations_snapshot(limit), indent=1), \
            "application/json"

    def kvcache_page(req):
        if f"{_PKG}.kvcache" not in sys.modules:
            return "no kv-cache stores registered\n"
        from ..kvcache import kvcache_snapshot
        snap = kvcache_snapshot()
        if not snap["stores"]:
            return "no kv-cache stores registered\n"
        return json.dumps(snap, indent=1), "application/json"

    def cluster_page(req):
        # per router: the replica table (health, breaker isolations,
        # quarantine, ladder level), session counts and resume stats,
        # the overload gradient's per-level fire counters
        if f"{_PKG}.serving" not in sys.modules:
            return "no cluster routers registered\n"
        from ..serving import cluster_snapshot
        snap = cluster_snapshot()
        if not snap["routers"]:
            return "no cluster routers registered\n"
        return json.dumps(snap, indent=1), "application/json"

    def psserve_page(req):
        if f"{_PKG}.psserve" not in sys.modules:
            return "no parameter-server components registered\n"
        from ..psserve import psserve_snapshot
        snap = psserve_snapshot()
        if not snap["shards"] and not snap["clients"]:
            return "no parameter-server components registered\n"
        # a PS process is the fleet's I/O hot spot: its syscall
        # counters ride beside the shard tables
        from ..butil import flight
        snap["syscalls"] = flight.syscall_counters()
        return json.dumps(snap, indent=1), "application/json"

    def migration_page(req):
        if f"{_PKG}.migrate" not in sys.modules:
            return "no migration components registered\n"
        from ..migrate import migration_snapshot
        snap = migration_snapshot()
        if not snap["outbound"] and not snap["inbound"] \
                and not snap["standby"]:
            return "no migration components registered\n"
        return json.dumps(snap, indent=1), "application/json"

    def _seconds(req, default=1.0):
        try:
            return min(60.0, max(0.05, float(req.query.get("seconds",
                                                           default))))
        except ValueError:
            return default

    # /hotspots: the always-on sampler's ring (folded stacks rooted at
    # their serving stage, gil_wait_ratio, a per-stage run/wait table);
    # ?seconds=N a synchronous 100 Hz burst that blocks the thread
    # serving the request for N seconds; ?fmt=collapsed is flamegraph
    # input, ?fmt=pb the pprof proto
    def hotspots_index(req):
        from . import sampler as _sampler
        from .pprof_proto import encode_profile
        fmt = req.query.get("fmt", "text")
        if "seconds" in req.query:
            seconds = _seconds(req)
            hz = 100
            stacks = _sampler.burst(seconds, hz)
            if fmt in ("pb", "proto"):
                return (encode_profile(stacks, period_ns=int(1e9 / hz),
                                       duration_ns=int(seconds * 1e9)),
                        "application/octet-stream")
            if fmt == "collapsed":
                return "".join(f"{s} {n}\n"
                               for s, n in stacks.most_common())
            return _sampler.render_folded(
                stacks, f"hotspot burst: {seconds}s @ {hz}Hz, "
                        f"stage-tagged")
        samp = _sampler.HotspotSampler.instance()
        stacks = samp.folded()
        if fmt in ("pb", "proto"):
            hz = float(samp.snapshot()["hz"]) or 10.0
            return (encode_profile(stacks, period_ns=int(1e9 / hz),
                                   duration_ns=int(
                                       samp.window_s * len(samp._windows())
                                       * 1e9)),
                    "application/octet-stream")
        if fmt == "collapsed":
            return "".join(f"{s} {n}\n" for s, n in stacks.most_common())
        snap = samp.snapshot()
        lines = [
            f"--- always-on hotspot sampler: "
            f"{'RUNNING' if snap['running'] else 'STOPPED'} "
            f"@ {snap['hz']:g}Hz, {snap['windows']} windows x "
            f"{snap['window_s']:g}s, {snap['samples']} samples ---",
            f"gil_wait_ratio: {snap['gil_wait_ratio']} "
            f"(lock/queue-wait samples / all samples; also a bvar on "
            f"/brpc_metrics)",
            "",
        ]
        body = _sampler.render_folded(stacks,
                                      "ring profile (stage-tagged)") \
            if stacks else ("(no samples yet — sampler disabled or "
                            "just started; flip hotspot_sampler_enabled "
                            "on /flags)\n")
        tail = ("\nargs: ?seconds=N (synchronous 100Hz burst) "
                "?fmt=collapsed|pb\n"
                "locks: /hotspots/locks (contention ledger)\n")
        return "\n".join(lines) + body + tail

    def hotspots_locks(req):
        # the lock ledger (butil/lockprof.py): per named lock the
        # acquisitions, contentions, wait and hold latencies and the
        # last holder's stage; then the lock-order witness
        from ..butil import lockprof
        snap = lockprof.locks_snapshot()
        if req.query.get("fmt") == "json":
            return json.dumps({
                "ledger": snap,
                "witness": {
                    "enabled": lockprof.witness_enabled(),
                    "held": lockprof.held_locks_snapshot(),
                    "edges": lockprof.lock_order_edges(),
                    "violations": [
                        {k: v for k, v in viol.items() if k != "stack"}
                        for viol in lockprof.order_violations()],
                },
            }, indent=1), "application/json"
        if not snap:
            return ("no instrumented locks registered yet\n\n"
                    + lockprof.witness_report())
        cols = ("acquisitions", "contentions", "contention_ratio",
                "wait_avg_us", "wait_p99_us", "wait_max_us",
                "hold_avg_us", "hold_p99_us", "hold_max_us")
        lines = ["--- lock-contention ledger (named hot locks; "
                 "wait/hold recorders also on /brpc_metrics as "
                 "lock_<name>_{wait,hold}_us) ---", "",
                 f"{'lock':<18}" + "".join(f"{c:>18}" for c in cols)
                 + f"  {'last_holder_stage'}"]
        for name, st in snap.items():
            lines.append(
                f"{name:<18}"
                + "".join(f"{st[c]:>18}" for c in cols)
                + f"  {st['last_holder_stage']}")
        return "\n".join(lines) + "\n\n" + lockprof.witness_report()

    def vlog_page(req):
        """Python loggers and the native core's minimum level, each
        live-settable: ``?set=<logger>=<level>`` (logger ``<native>``
        sets the C++ core's sink threshold)."""
        import logging as _logging
        msg = ""
        if "set" in req.query:
            name, _, level = req.query["set"].partition("=")
            try:
                lv = int(level) if level.lstrip("-").isdigit() \
                    else getattr(_logging, level.upper())
                if name == "<native>":
                    core.brpc_set_min_log_level(int(lv))
                else:
                    _logging.getLogger(name or None).setLevel(lv)
                msg = f"set {name or 'root'} to {lv}"
            except (AttributeError, ValueError, TypeError) as e:
                msg = f"bad set request: {e}"
        lines = [msg, "logger                               level", "-" * 44]
        root = _logging.getLogger()
        lines.append(f"{'root':36} {_logging.getLevelName(root.level)}")
        for name in sorted(_logging.Logger.manager.loggerDict):
            lg = _logging.Logger.manager.loggerDict[name]
            if isinstance(lg, _logging.Logger):
                lines.append(
                    f"{name:36} "
                    f"{_logging.getLevelName(lg.level)}"
                    f"{' (inherits)' if lg.level == 0 else ''}")
        lines.append(f"{'<native>':36} (set via ?set=<native>=<int>)")
        lines.append("")
        lines.append(f"usage: /vlog?set=<logger>=<level>   e.g. "
                     f"?set={_PKG}=DEBUG or ?set=<native>=2")
        return "\n".join(filter(None, lines)) + "\n"

    def dir_page(req):
        """Filesystem browser, off unless ``enable_dir_service`` was set
        at process start: directories list as links, regular files
        stream back (the first MiB)."""
        import os
        import stat
        from urllib.parse import quote, unquote
        if not get_flag("enable_dir_service"):
            return ("/dir is disabled; set enable_dir_service=true at "
                    "process start to allow filesystem browsing\n")
        target = unquote(req.path[len("/dir"):]) or "/"
        target = os.path.normpath(target)
        if not target.startswith("/"):
            target = "/" + target
        try:
            if os.path.isdir(target):
                rows = []
                parent = os.path.dirname(target.rstrip("/")) or "/"
                rows.append(f'<li><a href="/dir{quote(parent)}">..</a></li>')
                for e in sorted(os.listdir(target)):
                    p = os.path.join(target, e)
                    mark = "/" if os.path.isdir(p) else ""
                    rows.append(f'<li><a href="/dir{quote(p)}">'
                                f'{html.escape(e)}{mark}</a></li>')
                return (f"<html><body><h3>{html.escape(target)}</h3>"
                        f"<ul>{''.join(rows)}</ul></body></html>",
                        "text/html")
            # regular files only: an open() on a FIFO would park this
            # console thread forever
            if not stat.S_ISREG(os.stat(target).st_mode):
                return f"not a regular file: {target}\n"
            with open(target, "rb") as f:
                data = f.read(1 << 20)
            return data, "application/octet-stream"
        except OSError as e:
            return f"cannot read {target}: {e}\n"

    def flightrecorder_page(req):
        # the native flight recorder: the merged tail of the per-thread
        # rings, what every native thread last did, the recorder's
        # stats and the syscall counters
        from ..butil import flight
        try:
            limit = min(4096, max(1, int(req.query.get("limit", "200"))))
        except ValueError:
            limit = 200
        if req.query.get("fmt") == "json":
            return json.dumps({
                "available": flight.available(),
                "enabled": flight.enabled(),
                "stats": flight.stats(),
                "syscalls": flight.syscall_counters(),
                "bytes_per_write": flight.write_size_hist(),
                "threads": flight.threads(),
                "events": flight.events(limit),
            }, indent=1), "application/json"
        hist = flight.write_size_hist()
        hist_line = "  ".join(f"le_{k}={v}" for k, v in hist.items()
                              if v) or "(no writes yet)"
        return (flight.report(limit)
                + f"\nbytes_per_write: {hist_line}\n"
                + "\nargs: ?limit=N (tail size) ?fmt=json\n"
                + "flip recording live: /flags?setvalue="
                + "flight_recorder_enabled&value=false\n")

    fleet = _not_ported("ROADMAP Queue 1 item 7, second half (the fleet "
                        "pages)")
    profiler = _not_ported("builtin/profiler.py (ROADMAP Queue 1 item 6)")
    routes = {
        "/": index, "/index": index,
        "/dashboard": dashboard,
        "/status": status,
        "/vars": vars_page,
        "/flags": flags_page,
        "/health": health,
        "/version": version,
        "/connections": connections,
        "/sockets": sockets,
        "/bthreads": bthreads,
        "/rpcz": rpcz_page,
        "/brpc_metrics": metrics,
        "/services": services_page,
        "/protobufs": services_page,
        "/memory": memory,
        "/ici": _not_ported("ROADMAP Queue 1 item 8 (the ICI transport)"),
        "/serving": serving_page,
        "/serving/generations": serving_generations_page,
        "/kvcache": kvcache_page,
        "/migration": migration_page,
        "/cluster": cluster_page,
        "/fleet": fleet,
        "/psserve": psserve_page,
        "/flightrecorder": flightrecorder_page,
        "/hotspots": hotspots_index,
        "/hotspots/locks": hotspots_locks,
        "/hotspots/cpu": profiler,
        "/hotspots/native": profiler,
        "/hotspots/contention": profiler,
        "/hotspots/heap": profiler,
        "/hotspots/growth": profiler,
        "/pprof/profile": profiler,
        "/pprof/profile_native": profiler,
        "/pprof/contention": profiler,
        "/pprof/heap": profiler,
        "/pprof/growth": profiler,
        "/vlog": vlog_page,
        "/dir": dir_page,
        "/dir/": dir_page,     # prefix route: /dir/<abs path>
    }
    return routes


class _DashHistory:
    """Two minutes of per-second (count, sum_us) samples per method: the
    data behind /dashboard's sparklines."""

    def __init__(self, server):
        from collections import deque
        self._server = server
        self.samples = deque(maxlen=120)   # (ts, {key: (count, sum_us)})
        self._started = False
        self._mu = threading.Lock()

    def ensure(self):
        with self._mu:
            if self._started:
                return
            self._started = True
            threading.Thread(target=self._run, daemon=True,
                             name="console-dashboard").start()

    def _run(self):
        while self._server.running:
            snap = {}
            for key, st in self._server.method_statuses.items():
                c, s_us, _ = st.latency_rec.snapshot()  # one native call
                snap[key] = (c, s_us)
            self.samples.append((time.time(), snap))
            time.sleep(1.0)


def _dash_history_for(server) -> _DashHistory:
    """One history (and one sampling thread) per Server."""
    h = getattr(server, "_dash_history", None)
    if h is None or h._server is not server:
        h = _DashHistory(server)
        server._dash_history = h
    return h


def _spark(points, width=240, height=36):
    if len(points) < 2:
        return "<svg width='240' height='36'></svg>"
    top = max(points) or 1
    n = len(points)
    coords = " ".join(
        f"{i * width / (n - 1):.1f},"
        f"{height - 2 - (v / top) * (height - 6):.1f}"
        for i, v in enumerate(points))
    return (f"<svg width='{width}' height='{height}'>"
            f"<polyline points='{coords}' fill='none' "
            f"stroke='#36c' stroke-width='1.5'/>"
            f"<text x='{width - 4}' y='10' text-anchor='end' "
            f"font-size='9' fill='#666'>{top:.4g}</text></svg>")


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v


def _apply_flag_side_effects(name: str) -> None:
    """What setting a flag on /flags must do beyond storing it (rpcz
    reads its enable and sample-rate flags directly)."""
    if name == "rpcz_database_dir":
        rpcz.set_database_dir(get_flag("rpcz_database_dir", "") or None)
    elif name == "flight_recorder_enabled":
        from ..butil import flight
        flight.apply_flag()
    elif name == "hotspot_sampler_enabled":
        from .sampler import HotspotSampler
        if get_flag("hotspot_sampler_enabled", True):
            HotspotSampler.ensure_started()
        else:
            HotspotSampler.instance().stop()
