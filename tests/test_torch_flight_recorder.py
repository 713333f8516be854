"""The port's flight recorder surface (``brpc_tpu_torch/butil/flight.py``
over its own core's ``src/cc/butil/flight.cc``), the counterparts of
``tests/test_flight_recorder.py``:

  * ring semantics: events parse with known kinds, a ring wraps
    keeping its newest 2048, the thread table accounts the overwritten
    ones, dumps taken while four threads write are consistent, exited
    threads' rings are reused, the off switch records nothing, and the
    reloadable flag drives the native gate;
  * the wedge autopsy: a native stall past a deadline dumps a report
    (and a file) naming the stalled worker and its last event;
  * syscall attribution, process-wide and per socket;
  * ``/flightrecorder`` (text, ``?fmt=json``, ``?limit=``), the
    recorder's variables on ``/brpc_metrics``, the ``/flags`` side
    effect and ``/psserve``'s syscall block;
  * parity with the JAX package's ``brpc_tpu/butil/flight.py``: the same
    dump texts parse to the same events, thread rows and report in both
    modules, both cores keep and account a wrapped ring alike, the
    exposed variables and the histogram labels are the same, and both
    servers' ``/flightrecorder`` pages have the same shape.

Deterministic where the reference's two flaky tests were not: a thread
reads as exited only once its native ring says so (the interpreter's
``join`` returns before the thread's native exit hooks run), and the
dumps taken while writing are made while the writers are known to run.
Every thread a test starts is joined with a deadline; the probe
threads' native entries run under the suite's ``WedgeGuard``.
"""
import ctypes
import http.client
import json
import re
import sys
import threading
import time

import pytest

import brpc_tpu as ref
from brpc_tpu._core import core as ref_core
from brpc_tpu.butil import flight as ref_flight
from brpc_tpu.bvar import variable as ref_variable
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import flags, native_path
from brpc_tpu_torch._core import lib as core_lib
from brpc_tpu_torch.butil import flight, lockprof
from brpc_tpu_torch.bvar import variable

from testutil import wait_until
from tests.wedge_guard import WedgeGuard

RING_CAP = 2048          # butil::flight::kRingCap
STALL_MARK = 0x57A11     # the stall probe's marker event (capi.cc)
JOIN_S = 30.0

# the probe threads' native entries run under the suite's wedge guard
guard = WedgeGuard("port flight recorder native entry", deadline_s=JOIN_S)


@pytest.fixture(scope="module")
def core():
    c = core_lib.load()[0]
    flight.set_enabled(True)
    yield c
    flight.set_enabled(True)


class _Emitter:
    """A fresh thread that records ``n`` probe events tagged ``tag`` on
    its own (new, empty) ring, then stays alive until released, so its
    ring can be read before anything can reuse it."""

    def __init__(self, core, n, tag, fl=flight):
        self.tid = None
        self._fl = fl
        self._emitted = threading.Event()
        self._release = threading.Event()
        self._t = guard.start_thread(self._run, core, n, tag)
        assert self._emitted.wait(JOIN_S), "the probe emitter hung"

    def _run(self, core, n, tag):
        self.tid = threading.get_native_id()
        core.brpc_flight_selftest_emit(n, tag)
        self._emitted.set()
        self._release.wait(JOIN_S)

    def row(self):
        rows = [t for t in self._fl.threads() if t["tid"] == self.tid]
        return rows[0] if rows else None

    def exit(self):
        """Let the thread end, and wait until its ring reads exited."""
        self._release.set()
        guard.join_thread(self._t, what="flight selftest emit")
        # (a thread that recorded nothing while the recorder was off
        # has no ring at all)
        assert wait_until(lambda: not (self.row() or {"live": 0})["live"],
                          JOIN_S), "the ring never read exited"


def _mine(tag, limit=8192, fl=flight):
    return [e for e in fl.events(limit)
            if e["kind"] == "probe" and e["a"] == tag]


# ---------------------------------------------------------------------------
# ring semantics
# ---------------------------------------------------------------------------

def test_available_everywhere_the_port_runs(core):
    assert flight.available()
    assert native_path.flight_recorder() is flight


def test_events_parse_and_carry_known_kinds(core):
    em = _Emitter(core, 10, 0xE1)
    try:
        mine = _mine(0xE1)
        assert len(mine) == 10
        assert [e["b"] for e in mine] == list(range(10))
        assert {e["tid"] for e in mine} == {em.tid}
        for e in flight.events(4096):
            assert set(e) == {"ts_us", "tid", "thread", "kind", "a", "b"}
            assert e["kind"] != "?", e
    finally:
        em.exit()


def test_ring_wraps_overwriting_oldest(core):
    n = RING_CAP * 2 + RING_CAP // 2
    em = _Emitter(core, n, 0x77)
    try:
        mine = _mine(0x77)
        # only the newest kRingCap survive, and they are exactly the tail
        assert len(mine) == RING_CAP
        assert {e["b"] for e in mine} == set(range(n - RING_CAP, n))
    finally:
        em.exit()


def test_overwrite_accounting_in_thread_table(core):
    n = RING_CAP + 1000
    em = _Emitter(core, n, 0x88)
    em.exit()
    row = em.row()
    assert row is not None, "no thread row for the emitter"
    assert row["events"] == n
    assert row["dropped"] == n - RING_CAP
    assert row["last"] == "probe"
    assert not row["live"]
    assert row["age_us"] >= 0


def test_concurrent_writers_with_dump_while_writing(core):
    """Four writers record while this thread dumps: every dump is taken
    while all four are writing, every event in it is consistent (within
    one dump a writer's probe sequence strictly increases), and the
    final count is exact."""
    before = flight.stats()["events"]
    stop = threading.Event()
    counts = [0] * 4
    started = [threading.Event() for _ in range(4)]
    chunk = 4096

    def writer(w):
        call = 0
        while not stop.is_set():
            # a fresh tag per call: b restarts at 0 with each call
            core.brpc_flight_selftest_emit(chunk, (0xC0 + w) << 24 | call)
            counts[w] += chunk
            call += 1
            started[w].set()

    ts = [guard.start_thread(writer, w) for w in range(4)]
    try:
        assert all(e.wait(JOIN_S) for e in started)
        for _ in range(12):
            seen = {}
            for e in flight.events(512):
                if e["kind"] != "probe" or (e["a"] >> 24) not in \
                        range(0xC0, 0xC4):
                    continue
                key = (e["tid"], e["a"])
                prev = seen.get(key)
                assert prev is None or e["b"] > prev, \
                    (f"torn or duplicated event in a dump: {key} "
                     f"b={e['b']} after {prev}")
                seen[key] = e["b"]
            assert seen, "a dump taken mid-write held no writer event"
            flight.threads()      # the table read races the writers too
            assert all(t.is_alive() for t in ts)
    finally:
        stop.set()
        for t in ts:
            guard.join_thread(t, what="flight concurrent writer")
    assert flight.stats()["events"] - before >= sum(counts)


def test_ring_recycling_bounds_population(core):
    """Thread churn does not grow the ring population (an exited
    thread's ring is reused) and the cumulative event count survives
    the reuse."""
    before = flight.stats()
    for _ in range(20):
        _Emitter(core, 100, 0x99).exit()
    after = flight.stats()
    assert after["threads"] <= before["threads"] + 2, (before, after)
    assert after["events"] >= before["events"] + 20 * 100


def test_disabled_flag_is_a_recording_no_op(core):
    flight.set_enabled(False)
    try:
        assert not flight.enabled()
        before = flight.stats()["events"]
        em = _Emitter(core, 1000, 0xDD)
        em.exit()
        assert flight.stats()["events"] == before
        assert not _mine(0xDD)
    finally:
        flight.set_enabled(True)
    assert flight.enabled()


def test_reloadable_flag_drives_the_native_gate(core):
    try:
        assert flags.set_flag("flight_recorder_enabled", False)
        flight.apply_flag()
        assert not flight.enabled()
    finally:
        flags.set_flag("flight_recorder_enabled", True)
        flight.apply_flag()
    assert flight.enabled()


# ---------------------------------------------------------------------------
# the wedge autopsy: a deadline miss names the stalled worker
# ---------------------------------------------------------------------------

def _deadline_autopsy(fn, args, deadline_s, dump_dir):
    """Run ``fn(*args)`` on a thread; when it misses ``deadline_s``,
    write the flight report and the lock-order witness to stderr and to
    ``dump_dir/wedge_<ms>.log`` and return the text (None when it made
    the deadline).  The call is joined either way."""
    t = threading.Thread(target=fn, args=args, daemon=True,
                         name="flight-stall")
    t.start()
    t.join(deadline_s)
    text = None
    if t.is_alive():
        text = ("--- native flight recorder dump ---\n" + flight.report()
                + "--- lock-order witness dump ---\n"
                + lockprof.witness_report())
        sys.stderr.write(text)
        (dump_dir / f"wedge_{int(time.time() * 1e3)}.log").write_text(text)
    t.join(JOIN_S)
    assert not t.is_alive(), "the guarded native call never returned"
    return text


def test_forced_stall_dump_names_stalled_worker(core, capsys, tmp_path):
    """A native delay occupies one executor worker; the guarded call
    misses its deadline, and the autopsy on stderr and on disk names the
    stalled worker, whose last event is the stall marker."""
    text = _deadline_autopsy(core.brpc_flight_stall_probe, (1200,), 0.4,
                             tmp_path)
    assert text is not None, "the stall made its deadline"
    err = capsys.readouterr().err
    assert "native flight recorder dump" in err
    assert "last event of every native thread" in err
    stalled = [ln for ln in err.splitlines()
               if "worker/" in ln and "last=probe" in ln]
    assert stalled, f"no stalled-worker row in the dump:\n{err}"
    assert f"a=0x{STALL_MARK:x}" in err
    assert "lock-order witness dump" in err
    arts = list(tmp_path.glob("wedge_*.log"))
    assert arts, "no autopsy file written"
    saved = arts[0].read_text()
    assert f"a=0x{STALL_MARK:x}" in saved and "worker/" in saved


# ---------------------------------------------------------------------------
# syscall attribution, the console pages and the metrics export
# ---------------------------------------------------------------------------

class Hello(rpc.Service):
    @rpc.method(request="json", response="json")
    def Say(self, cntl, req):
        return {"hello": (req or {}).get("name", "world")}


@pytest.fixture(scope="module")
def server(core):
    srv = rpc.Server()
    srv.add_service(Hello())
    srv.start("127.0.0.1", 0)
    ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    ch.call_sync("Hello", "Say", {"name": "x"}, serializer="json")
    yield srv
    srv.stop()
    srv.join()


def _get(server, path):
    c = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    c.request("GET", path)
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, body


def test_syscall_counters_attribute_rpc_traffic(server):
    before = flight.syscall_counters()
    hist_before = sum(flight.write_size_hist().values())
    ch = rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=5000)
    for _ in range(5):
        ch.call_sync("Hello", "Say", {"name": "sys"}, serializer="json")
    after = flight.syscall_counters()
    assert after["write_syscalls"] > before["write_syscalls"]
    assert after["read_syscalls"] > before["read_syscalls"]
    # every counted write landed in exactly one histogram bucket
    assert sum(flight.write_size_hist().values()) > hist_before
    assert set(flight.write_size_hist()) == set(flight.WRITE_HIST_LABELS)


def test_per_socket_syscalls(server):
    ch = rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=5000)
    ch.call_sync("Hello", "Say", {"name": "per-sock"}, serializer="json")
    stats = [flight.socket_syscalls(sid) for sid in server.connections()]
    stats = [s for s in stats if s is not None]
    assert stats
    assert any(s["read_syscalls"] > 0 for s in stats)
    # a stale id reads None, not garbage
    assert flight.socket_syscalls(0xFFFFFFFF00000000) is None


def test_flightrecorder_page_text(server):
    status, body = _get(server, "/flightrecorder")
    assert status == 200
    text = body.decode()
    assert "flight recorder: ENABLED" in text
    assert "per-thread state" in text
    assert "merged event tail" in text
    assert "worker/" in text
    assert "syscalls:" in text


def test_flightrecorder_page_json(server):
    status, body = _get(server, "/flightrecorder?fmt=json&limit=20")
    assert status == 200
    snap = json.loads(body)
    assert snap["available"] and snap["enabled"]
    assert snap["stats"]["events"] > 0
    assert snap["stats"]["threads"] > 0
    assert len(snap["events"]) <= 20
    names = {t["thread"] for t in snap["threads"]}
    assert any(n.startswith("worker/") for n in names)
    assert any(n.startswith("epoll/") for n in names)
    assert "timer" in names or "ext" in names
    assert snap["syscalls"]["write_syscalls"] > 0
    assert set(snap["bytes_per_write"]) == set(flight.WRITE_HIST_LABELS)
    for e in snap["events"]:
        assert set(e) == {"ts_us", "tid", "thread", "kind", "a", "b"}


def test_flightrecorder_limit_bounds_tail(server):
    _, b5 = _get(server, "/flightrecorder?fmt=json&limit=5")
    assert len(json.loads(b5)["events"]) <= 5
    # a bad limit falls back instead of failing
    status, _ = _get(server, "/flightrecorder?limit=bogus")
    assert status == 200


def test_flight_and_syscall_vars_on_metrics(server):
    status, body = _get(server, "/brpc_metrics")
    assert status == 200
    text = body.decode()
    assert "flight_events_recorded" in text
    assert "socket_write_syscalls" in text
    assert "socket_read_syscalls" in text
    assert "socket_write_batch_hits" in text
    assert 'socket_bytes_per_write{le="64"}' in text


def test_flags_page_switches_the_recorder(server):
    try:
        assert _get(server, "/flags?setvalue=flight_recorder_enabled"
                            "&value=false") == (200, b"ok\n")
        assert not flight.enabled()
        assert b"ENABLED" not in _get(server, "/flightrecorder")[1]
    finally:
        _get(server, "/flags?setvalue=flight_recorder_enabled&value=true")
    assert flight.enabled()


def test_psserve_page_carries_syscalls(server):
    from brpc_tpu_torch import psserve
    shard = psserve.EmbeddingShardServer(0, 1, 16, 4, device="cpu")
    ps_server = rpc.Server()
    psserve.register_psserve(ps_server, shard)
    ps_server.start("127.0.0.1", 0)
    try:
        status, body = _get(ps_server, "/psserve")
        assert status == 200
        snap = json.loads(body)
        assert set(snap["syscalls"]) == {"read_syscalls", "write_syscalls",
                                         "batch_hits", "batch_misses"}
        assert snap["syscalls"]["read_syscalls"] > 0
    finally:
        ps_server.stop()
        ps_server.join()


# ---------------------------------------------------------------------------
# parity with the JAX package's recorder surface
# ---------------------------------------------------------------------------

_SURFACE = ("available", "enabled", "set_enabled", "apply_flag", "stats",
            "events", "threads", "syscall_counters", "write_size_hist",
            "socket_syscalls", "report", "expose_flight_variables")


def test_surface_flag_and_labels_match_the_reference():
    for name in _SURFACE:
        assert callable(getattr(flight, name)), name
        assert callable(getattr(ref_flight, name)), name
    assert flight.WRITE_HIST_BUCKETS == ref_flight.WRITE_HIST_BUCKETS
    assert flight.WRITE_HIST_LABELS == ref_flight.WRITE_HIST_LABELS
    ours = flags._flags["flight_recorder_enabled"]
    from brpc_tpu import flags as ref_flags
    theirs = ref_flags._flags["flight_recorder_enabled"]
    assert (ours.default, ours.reloadable, ours.help) == \
        (theirs.default, theirs.reloadable, theirs.help)


class _FakeCore:
    """Answers the recorder's native entries with fixed dump texts and
    counters, so the same native output reaches both packages'
    parsers."""

    def __init__(self, dump, table, on=True):
        self.dump, self.table, self.on = dump.encode(), table.encode(), on

    @staticmethod
    def _fill(buf, size, data):
        data = data[:size - 1]
        ctypes.memmove(buf, data, len(data))
        return len(data)

    def brpc_flight_enabled(self):
        return int(self.on)

    def brpc_flight_dump(self, buf, size, limit):
        lines = self.dump.splitlines(keepends=True)[-limit:]
        return self._fill(buf, size, b"".join(lines))

    def brpc_flight_threads(self, buf, size):
        return self._fill(buf, size, self.table)

    def brpc_flight_stats(self, ev, th, dr):
        ev._obj.value, th._obj.value, dr._obj.value = 4242, 7, 99

    def brpc_syscall_counters(self, rd, wr, hit, miss):
        for i, ref_ in enumerate((rd, wr, hit, miss)):
            ref_._obj.value = 100 + i

    def brpc_write_size_hist(self, arr, n):
        for i in range(n):
            arr[i] = 3 * i
        return n - 2         # a core that fills fewer buckets

    def brpc_socket_syscalls(self, sid, rd, wr):
        if sid.value != 7:
            return -1
        rd._obj.value, wr._obj.value = 11, 12
        return 0


_DUMP = "\n".join([
    "1000 41 worker/0 task_begin a=0x1f b=0",
    "1001 41 worker/0 task_end a=0x1f b=3",
    "1002 42 epoll/0 sock_read a=0xdeadbeef b=512",
    "1003 43 ext probe a=0xa5 b=18446744073709551615",
    "1004 44 timer",                                   # too few fields
    "1005 44 timer fire a=0xzz b=1",                   # bad hex
    "1006 44 timer fire a=0x10 b=one",                 # bad decimal
    "1007 45 worker/1 butex_wait a=0x20 b=7 extra",    # too many fields
    "",
    "1008 46 worker/2 steal a=0x0 b=-1",
])
_TABLE = "\n".join([
    "41 worker/0 live events=12 dropped=0 last=task_end age_us=15",
    "42 epoll/0 live events=3 dropped=0 last=sock_read age_us=9001",
    "43 ext exited events=4096 dropped=2048 last=probe age_us=0",
    "44 timer live events=x dropped=0 last=fire age_us=1",   # bad count
    "45 worker/1 live events=1 dropped=0 last=park",         # too short
    "46 worker/2 live events=1 dropped=0 last=steal nope=1",  # no age_us
    "47 worker/3 gone events=5 dropped=1 last=unpark age_us=3",
])


def _live_dump_texts():
    """The port core's own dump and thread table, as its entries print
    them."""
    c = core_lib.load()[0]
    buf = ctypes.create_string_buffer(1 << 20)
    c.brpc_flight_dump(buf, len(buf), 300)
    tab = ctypes.create_string_buffer(1 << 18)
    c.brpc_flight_threads(tab, len(tab))
    return buf.value.decode(), tab.value.decode()


@pytest.mark.parametrize("source", ["crafted", "live"])
def test_parsers_and_report_match_the_reference(core, monkeypatch, source):
    dump, table = (_DUMP, _TABLE) if source == "crafted" \
        else _live_dump_texts()
    fake = _FakeCore(dump, table)
    monkeypatch.setattr(flight, "_core", lambda: fake)
    monkeypatch.setattr(ref_flight, "_core", lambda: fake)
    got = []
    for fl in (flight, ref_flight):
        got.append({
            "events": fl.events(512), "tail": fl.events(3),
            "threads": fl.threads(), "stats": fl.stats(),
            "syscalls": fl.syscall_counters(),
            "hist": fl.write_size_hist(),
            "sock": fl.socket_syscalls(7), "stale": fl.socket_syscalls(8),
            "enabled": fl.enabled(), "report": fl.report(50)})
    assert got[0] == got[1]
    if source == "crafted":
        ev = got[0]["events"]
        assert [e["ts_us"] for e in ev] == [1000, 1001, 1002, 1003, 1008]
        assert ev[3]["b"] == 2 ** 64 - 1 and ev[4]["b"] == -1
        assert [t["tid"] for t in got[0]["threads"]] == [41, 42, 43, 47]
        assert got[0]["threads"][3]["live"] is False
    else:
        assert got[0]["events"] and got[0]["threads"]


def test_ring_wrap_and_accounting_match_the_reference(core):
    """One scenario on each core: a fresh thread records RING_CAP + 1000
    probe events and exits; both keep the same newest events and account
    the same overwritten ones in their thread tables."""
    n, tag = RING_CAP + 1000, 0xA5
    seen = []
    for fl, c in ((flight, core), (ref_flight, ref_core)):
        em = _Emitter(c, n, tag, fl)
        kept = [e["b"] for e in _mine(tag, fl=fl)]
        em.exit()
        row = em.row()
        seen.append((kept, {k: row[k] for k in
                            ("events", "dropped", "last", "live")}))
    assert seen[0] == seen[1]
    assert seen[0][0] == list(range(n - RING_CAP, n))
    assert seen[0][1] == {"events": n, "dropped": n - RING_CAP,
                          "last": "probe", "live": False}


def test_exposed_variables_match_the_reference(monkeypatch):
    """Both packages' ``expose_flight_variables`` expose the same names,
    and the bytes-per-write family the same label cells."""
    exposed = {}
    for fl, var in ((flight, variable), (ref_flight, ref_variable)):
        made = {}

        def record(self, name, made=made):
            made[name] = self
            return self

        monkeypatch.setattr(var.Variable, "expose", record)
        monkeypatch.setattr(fl, "_exposed", False)
        fl.expose_flight_variables()
        # (a labelled family's cells, read once it is filled)
        exposed[fl] = {name: (type(v).__name__,
                              sorted(getattr(v, "_stats", {})))
                       for name, v in made.items()}
    assert exposed[flight] == exposed[ref_flight]
    assert "flight_events_recorded" in exposed[flight]
    assert exposed[flight]["socket_bytes_per_write"] == (
        "MultiDimension", sorted((lb,) for lb in flight.WRITE_HIST_LABELS))


def _page_shape(text):
    """The text page's section lines and headers, with their numbers
    taken out (and the histogram's buckets, which the traffic picks)."""
    rows = [ln for ln in text.splitlines() if not ln.startswith("  ")]
    return [re.sub(r"\d+", "N", ln.split(" le_")[0]) for ln in rows]


def _json_shape(snap):
    def fam(name):
        return re.sub(r"/\d+$", "", name)
    return {
        "top": sorted(snap),
        "stats": sorted(snap["stats"]),
        "syscalls": sorted(snap["syscalls"]),
        "bytes_per_write": list(snap["bytes_per_write"]),
        "event": sorted({tuple(sorted(e)) for e in snap["events"]}),
        "thread": sorted({tuple(sorted(t)) for t in snap["threads"]}),
        "families": {"worker", "epoll"} & {fam(t["thread"])
                                           for t in snap["threads"]},
        "available": snap["available"], "enabled": snap["enabled"],
    }


def test_flightrecorder_page_matches_the_reference(server):
    ref_srv = ref.Server()
    ref_srv.add_service(ref_hello())
    ref_srv.start("127.0.0.1", 0)
    try:
        ref.Channel(f"127.0.0.1:{ref_srv.port}", timeout_ms=5000).call_sync(
            "Hello", "Say", {"name": "r"}, serializer="json")
        shapes = []
        for srv in (server, ref_srv):
            status, body = _get(srv, "/flightrecorder?fmt=json&limit=40")
            assert status == 200
            snap = json.loads(body)
            status, text = _get(srv, "/flightrecorder?limit=5")
            assert status == 200
            shapes.append((_json_shape(snap), _page_shape(text.decode())))
    finally:
        ref_srv.stop()
        ref_srv.join()
    assert shapes[0] == shapes[1]
    assert shapes[0][0]["families"] == {"worker", "epoll"}
    assert shapes[0][0]["event"] == [("a", "b", "kind", "thread", "tid",
                                      "ts_us")]


def ref_hello():
    class Hello(ref.Service):
        @ref.method(request="json", response="json")
        def Say(self, cntl, req):
            return {"hello": (req or {}).get("name", "world")}
    return Hello()
