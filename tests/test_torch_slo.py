"""The port's SLO engine, canary loop, ``/fleet`` and stitched traces
held against the JAX package's.

Counterparts of ``tests/test_telemetry.py``'s ``TestSLOEngine`` (burn
verdicts over a real collector fed by stand-in metrics, a stand-in
router recording the pushes), ``TestCanaryLoopE2E`` (a healthy canary
promoted and a slow one rolled back over real traffic through the port's
router, every stream bit-exact to one version's oracle) and
``TestThreeProcessTraceStitching`` (one ``/rpcz?trace_id=`` tree from
three processes; the two helper processes run the port's RPC front,
which imports without torch).  Then the two packages together: both
SLO engines over one scripted series give the same verdicts, states,
pushes and trails; ``/fleet`` and the fleet families of
``/brpc_metrics`` carry the same timing-free fields for the same router
state.
"""
import http.client
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from brpc_tpu_torch import rpc, rpcz
from brpc_tpu_torch.serving.slo import (BURNING, HOLD, INSUFFICIENT,
                                        PROMOTED, RAMPING, ROLLED_BACK,
                                        Objective, SLOEngine)
from brpc_tpu_torch.serving.telemetry import FleetCollector
from brpc_tpu_torch.tools.rpc_press import (expected_model_tokens,
                                            spin_up_multimodel_cluster,
                                            tear_down_multimodel_cluster)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _reset_policy():
    """No endpoint marked broken and no breaker state: an earlier test's
    stopped server can leave its port marked, and a replica that reuses
    the port would read as down (the router answers ENODATA)."""
    from brpc_tpu_torch.policy import circuit_breaker, health_check
    health_check.reset_all()
    b = circuit_breaker.global_breaker()
    with b._mu:
        b._short.clear()
        b._long.clear()
        b._isolation_count.clear()
        b._recovering_until.clear()


@pytest.fixture(autouse=True)
def _hygiene():
    from brpc_tpu_torch import fault
    fault.clear()
    _reset_policy()
    yield
    rpcz.set_current_span(None)
    rpcz.set_enabled(False)
    fault.clear()
    _reset_policy()


class _FakeMetrics:
    """snapshot()-compatible stand-in for ModelMetrics."""

    def __init__(self):
        self.rows = {}

    def set(self, model, *, ttft_ms=None, itl_ms=None,
            finished=0, failed=0):
        self.rows[model] = {
            "ttft": {"p99_ms": ttft_ms}, "itl": {"p99_ms": itl_ms},
            "finished": finished, "failed": failed,
        }

    def snapshot(self):
        return dict(self.rows)


class _FakeRouter:
    def __init__(self):
        self.pushes = []

    def deploy_model(self, model, *, op="deploy", weight=1, state=None,
                     addrs=None):
        self.pushes.append((op, model, weight, state))
        return {}


# ---------------------------------------------------------------------------
# the engine's verdicts
# ---------------------------------------------------------------------------

def _engine(objs=None, **kw):
    # wide enough that a ~0.05 s feed/tick loop always lands >= 2
    # samples inside the SHORT window (the burn's data floor)
    kw.setdefault("short_window_s", 0.15)
    kw.setdefault("long_window_s", 0.4)
    kw.setdefault("clean_windows", 2)
    return SLOEngine("m", "m@v1", "m@v2",
                     objs or [Objective("itl_p99_ms", 10.0)], **kw)


def _feed(c, m, *, base_itl=5.0, can_itl=5.0, n=3, dt=0.02):
    """n samples for both deployment keys, dt apart."""
    for _ in range(n):
        m.set("m@v1", ttft_ms=5.0, itl_ms=base_itl, finished=1)
        m.set("m@v2", ttft_ms=5.0, itl_ms=can_itl, finished=1)
        c.sample_models(m)
        time.sleep(dt)


class TestSLOEngine:
    def test_insufficient_until_both_windows_have_data(self):
        c = FleetCollector("tslo_ins")
        try:
            eng = _engine()
            assert eng.tick(c, None) == INSUFFICIENT
            assert eng.state == RAMPING
        finally:
            c.close()

    def test_clean_windows_promote_and_push_the_ramp(self):
        c = FleetCollector("tslo_prom")
        r = _FakeRouter()
        try:
            eng = _engine()
            m = _FakeMetrics()
            _feed(c, m, n=6)
            deadline = time.monotonic() + 5.0
            while eng.state == RAMPING and time.monotonic() < deadline:
                _feed(c, m, n=1)
                eng.tick(c, r)
                time.sleep(0.03)
            assert eng.state == PROMOTED
            # winner re-deployed warm, loser drained: 100/0
            assert ("deploy", "m@v2", 1, "warm") in r.pushes
            assert ("drain", "m@v1", 1, None) in r.pushes
            acts = [e.get("action") for e in eng.trail()]
            assert "promote" in acts and "clean_window" in acts
            # terminal: a later burn cannot undo it
            _feed(c, m, can_itl=500.0, n=6)
            assert eng.tick(c, r) == PROMOTED
        finally:
            c.close()

    def test_burning_canary_rolls_back_when_baseline_is_clean(self):
        c = FleetCollector("tslo_rb")
        r = _FakeRouter()
        try:
            eng = _engine()
            m = _FakeMetrics()
            _feed(c, m, can_itl=500.0, n=6)
            assert eng.tick(c, r) == BURNING
            assert eng.state == ROLLED_BACK
            assert ("deploy", "m@v1", 1, "warm") in r.pushes
            assert ("drain", "m@v2", 1, None) in r.pushes
            assert eng.floor() == 1        # shed at the router while burning
            assert any(e.get("action") == "rollback" for e in eng.trail())
        finally:
            c.close()

    def test_floor_clears_after_terminal_rollback(self):
        """After the rollback only the surviving baseline's burn counts:
        the drained canary's frozen series does not pin the floor."""
        c = FleetCollector("tslo_rbfloor")
        r = _FakeRouter()
        try:
            eng = _engine()
            m = _FakeMetrics()
            _feed(c, m, can_itl=500.0, n=6)
            eng.tick(c, r)
            assert eng.state == ROLLED_BACK and eng.floor() == 1
            _feed(c, m, can_itl=500.0, n=1)
            eng.tick(c, r)
            assert eng.floor() == 0
        finally:
            c.close()

    def test_fleet_wide_burn_is_not_the_canarys_fault(self):
        c = FleetCollector("tslo_fleet")
        r = _FakeRouter()
        try:
            eng = _engine(rollback_margin=10.0)
            m = _FakeMetrics()
            _feed(c, m, base_itl=500.0, can_itl=500.0, n=6)
            assert eng.tick(c, r) == BURNING
            assert eng.state == RAMPING and r.pushes == []
            assert eng.floor() == 1
        finally:
            c.close()

    def test_error_rate_objective_burns_on_failures(self):
        c = FleetCollector("tslo_err")
        try:
            eng = _engine([Objective("error_rate", 0.05)])
            m = _FakeMetrics()
            fin = fail = 0
            for _ in range(6):
                fin, fail = fin + 2, fail + 1          # 33% errors
                m.set("m@v1", finished=fin, failed=fail)
                m.set("m@v2", finished=fin, failed=fail)
                c.sample_models(m)
                time.sleep(0.02)
            assert eng.tick(c, _FakeRouter()) == BURNING
        finally:
            c.close()

    def test_disruption_holds_the_ramp(self):
        c = FleetCollector("tslo_hold")
        r = _FakeRouter()
        try:
            eng = _engine()
            m = _FakeMetrics()
            _feed(c, m, n=6)
            c.note_dead("r9:9")
            assert eng.tick(c, r) == HOLD
            assert eng.state == RAMPING and eng.holds == 1
            assert r.pushes == []
            assert eng.clean_streak == 0
        finally:
            c.close()

    def test_observe_only_engine_never_acts(self):
        c = FleetCollector("tslo_obs")
        r = _FakeRouter()
        try:
            eng = _engine(act=False)
            m = _FakeMetrics()
            _feed(c, m, can_itl=500.0, n=6)
            assert eng.tick(c, r) == BURNING
            assert eng.state == RAMPING and r.pushes == []
            assert eng.floor() == 1
            assert eng.snapshot()["last_eval"]["canary"]["verdict"] == \
                BURNING
        finally:
            c.close()


# ---------------------------------------------------------------------------
# the canary loop over real traffic
# ---------------------------------------------------------------------------

# the routers' fleet-telemetry pulls every second (default 0.25 s): in a
# process holding a whole test run's variables a pull takes long enough
# on the router's tick thread to starve the SLO engine's short windows
_ROUTER_KW = {"telemetry_pull_interval_s": 1.0}


def _drive_until(cli, engine, mults, router, *, want_state,
                 timeout_s=30.0):
    """Stream generations through the front door until the engine reads
    ``want_state``; each stream equals exactly one version's oracle."""
    deadline = time.monotonic() + timeout_s
    i = 0
    while engine.state != want_state:
        assert time.monotonic() < deadline, \
            f"engine stuck in {engine.state}: {engine.snapshot()}"
        prompt = [100 + (i % 7) + j for j in range(6)]
        g = cli.start(prompt, 4, model="m")
        assert g.wait(30) and g.error is None, \
            (g.error, router.stats()["replicas"])
        assert g.tokens in (
            expected_model_tokens(prompt, 4, mults["m@v1"]),
            expected_model_tokens(prompt, 4, mults["m@v2"])), g.tokens
        i += 1
    return i


class TestCanaryLoopE2E:
    def test_healthy_canary_auto_promotes_bit_exact(self):
        from brpc_tpu_torch.serving import RouterClient
        replicas, mults, router, rsrv, raddr = spin_up_multimodel_cluster(
            2, ["m@v1", "m@v2"], page_tokens=4, name_prefix="tslo_e2e_p",
            router_kw=_ROUTER_KW, device=CPU)
        try:
            router.deploy_model("m@v1", op="deploy", weight=3,
                                state="warm")
            router.deploy_model("m@v2", op="deploy", weight=1,
                                state="warm")
            eng = SLOEngine(
                "m", "m@v1", "m@v2",
                # generous targets: a healthy canary reads OK on a
                # loaded machine, never BURNING
                [Objective("ttft_p99_ms", 60_000.0),
                 Objective("itl_p99_ms", 60_000.0)],
                short_window_s=0.3, long_window_s=0.8, clean_windows=3)
            router.attach_slo(eng)
            cli = RouterClient(raddr, timeout_ms=10_000)
            _drive_until(cli, eng, mults, router, want_state=PROMOTED)
            assert list(router.catalog.version_weights("m")) == ["m@v2"]
            for _ in range(10):
                assert router.resolve_model("m") == "m@v2"
            p = [40, 41, 42, 43, 44, 45]
            g = cli.start(p, 5, model="m")
            assert g.wait(30) and g.error is None
            assert g.tokens == expected_model_tokens(p, 5, mults["m@v2"])
            assert "promote" in [e.get("action") for e in eng.trail()]
            assert router.fleet_snapshot()["slo"]["state"] == PROMOTED
        finally:
            tear_down_multimodel_cluster(replicas, router, rsrv)

    def test_slow_canary_auto_rolls_back_bit_exact(self):
        from brpc_tpu_torch.serving import RouterClient
        # ONLY the canary's engine is slow: slow, not wrong
        delay = [0.0]
        replicas, mults, router, rsrv, raddr = spin_up_multimodel_cluster(
            2, ["m@v1", "m@v2"], page_tokens=4,
            step_delay_s={"m@v2": lambda: delay[0]},
            name_prefix="tslo_e2e_r", router_kw=_ROUTER_KW, device=CPU)
        try:
            router.deploy_model("m@v1", op="deploy", weight=1,
                                state="warm")
            router.deploy_model("m@v2", op="deploy", weight=1,
                                state="warm")
            # the target from the baseline's own pace on this machine
            # (5 ms, the reference's, unless the baseline runs slower):
            # a loaded machine must not make the BASELINE burn, or its
            # advisory floor sheds the later sessions at the router.  The
            # router's p99 is cumulative: 120 gaps first, so one stall
            # of a loaded machine later does not move it
            cli = RouterClient(raddr, timeout_ms=20_000)
            for k in range(3):
                p = [10 + k, 11, 12, 13]
                g = cli.start(p, 41, model="m@v1")
                assert g.wait(30) and g.error is None
                assert g.tokens == expected_model_tokens(p, 41,
                                                         mults["m@v1"])
            base_p99 = router.model_metrics.snapshot()["m@v1"]["itl"][
                "p99_ms"]
            target = max(5.0, 3.0 * base_p99)
            # the canary's step burns the target ~10x, as 50 ms burns 5
            delay[0] = max(0.05, 0.01 * target)
            eng = SLOEngine(
                "m", "m@v1", "m@v2", [Objective("itl_p99_ms", target)],
                short_window_s=0.3, long_window_s=0.8,
                clean_windows=1000)         # never promote here
            router.attach_slo(eng)
            _drive_until(cli, eng, mults, router, want_state=ROLLED_BACK)
            assert list(router.catalog.version_weights("m")) == ["m@v1"]
            for _ in range(10):
                assert router.resolve_model("m") == "m@v1"
            p = [70, 71, 72, 73, 74, 75]
            g = cli.start(p, 5, model="m")
            assert g.wait(30) and g.error is None
            assert g.tokens == expected_model_tokens(p, 5, mults["m@v1"])
            acts = [e.get("action") for e in eng.trail()]
            assert "rollback" in acts and "promote" not in acts
            assert router.fleet_snapshot()["slo"]["state"] == ROLLED_BACK
        finally:
            tear_down_multimodel_cluster(replicas, router, rsrv)


# ---------------------------------------------------------------------------
# one /rpcz?trace_id= tree from three processes
# ---------------------------------------------------------------------------

_LEAF_SRC = """
import sys
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import rpcz
from brpc_tpu_torch.serving.telemetry import register_telemetry

rpcz.set_enabled(True, 1.0)


class Leaf(rpc.Service):
    @rpc.method(request="json", response="json")
    def Do(self, cntl, req):
        return {"leaf": "ok"}


srv = rpc.Server()
srv.add_service(Leaf())
register_telemetry(srv, name="leaf")
srv.start("127.0.0.1", 0)
print(f"PORT {srv.port} TORCH {'torch' in sys.modules}", flush=True)
sys.stdin.read()   # the parent closes stdin to stop us
srv.stop()
srv.join()
"""

_HOP_SRC = """
import sys
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import rpcz
from brpc_tpu_torch.serving.telemetry import register_telemetry

LEAF_ADDR = sys.argv[1]
rpcz.set_enabled(True, 1.0)
leaf_ch = rpc.Channel(LEAF_ADDR, timeout_ms=5000)


class Hop(rpc.Service):
    @rpc.method(request="json", response="json")
    def Fwd(self, cntl, req):
        # a client span around the onward call whose remote_side names
        # the leaf: the address the router's fan-out follows to reach a
        # process it never talks to
        span = rpcz.child_span("client", "Leaf", "Do")
        span.remote_side = LEAF_ADDR
        prev = rpcz.get_current_span()
        rpcz.set_current_span(span)
        try:
            return leaf_ch.call_sync("Leaf", "Do", {}, serializer="json")
        finally:
            rpcz.set_current_span(prev)
            rpcz.submit(span)


srv = rpc.Server()
srv.add_service(Hop())
register_telemetry(srv, name="hop")
srv.start("127.0.0.1", 0)
print(f"PORT {srv.port} TORCH {'torch' in sys.modules}", flush=True)
sys.stdin.read()
srv.stop()
srv.join()
"""


def _spawn_helper(tmp_path, name, src, *args):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(src))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, str(path), *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, cwd=REPO, text=True)
    line = proc.stdout.readline().split()
    assert line[:1] == ["PORT"], f"{name} failed to start: {line!r}"
    # the RPC front and the telemetry service run without torch
    assert line[2:] == ["TORCH", "False"], line
    return proc, f"127.0.0.1:{line[1]}"


def _stop_helper(proc):
    try:
        proc.stdin.close()
        proc.wait(timeout=10)
    except Exception:
        proc.kill()
        proc.wait(timeout=10)


class TestThreeProcessTraceStitching:
    def test_rpcz_trace_id_renders_spans_from_three_processes(
            self, tmp_path):
        from brpc_tpu_torch.serving import ClusterRouter, ReplicaHandle
        rpcz.set_enabled(True, 1.0)
        leaf = hop = router = None
        console_srv = rpc.Server()
        console_srv.start("127.0.0.1", 0)
        try:
            leaf, leaf_addr = _spawn_helper(tmp_path, "leaf", _LEAF_SRC)
            hop, hop_addr = _spawn_helper(tmp_path, "hop", _HOP_SRC,
                                          leaf_addr)
            # the router knows ONLY the hop; the leaf joins the tree
            # through the hop's client span's remote_side
            router = ClusterRouter([ReplicaHandle(hop_addr)],
                                   name="ttrace3_router", auto_tick=False)
            root = rpcz.new_span("client", "Hop", "Fwd")
            rpcz.set_current_span(root)
            try:
                ch = rpc.Channel(hop_addr, timeout_ms=10_000)
                assert ch.call_sync("Hop", "Fwd", {},
                                    serializer="json") == {"leaf": "ok"}
            finally:
                rpcz.set_current_span(None)
                rpcz.submit(root)
            rpcz.flush()
            tid = root.trace_id

            def pids_of(spans):
                return {s.span_id >> 40 for s in spans}   # pid-salted ids

            spans = []
            for _ in range(80):
                spans = router.trace_fanout(tid)
                if len(pids_of(spans)) >= 3:
                    break
                time.sleep(0.05)
            assert len(pids_of(spans)) >= 3, \
                f"only {pids_of(spans)} from {len(spans)} spans"
            kinds = {(s.kind, s.service) for s in spans}
            assert {("client", "Hop"), ("server", "Hop"),
                    ("client", "Leaf"), ("server", "Leaf")} <= kinds
            c = http.client.HTTPConnection("127.0.0.1", console_srv.port,
                                           timeout=10)
            c.request("GET", f"/rpcz?trace_id={tid}")
            resp = c.getresponse()
            body = resp.read().decode()
            c.close()
            assert resp.status == 200
            assert "stitched across 3 processes" in body
            assert "Leaf" in body and "Hop" in body
        finally:
            if router is not None:
                router.close(timeout_s=3.0)
            console_srv.stop()
            console_srv.join()
            for p in (hop, leaf):
                if p is not None:
                    _stop_helper(p)


# ---------------------------------------------------------------------------
# the two packages together
# ---------------------------------------------------------------------------

class _ScriptedCollector:
    """A collector whose windows read a fixed series: ``series[(model,
    metric)]`` is a list of ``(t, value)``; ``dead`` the times a replica
    was tombstoned."""

    def __init__(self, series, dead=()):
        self.series = series
        self.dead = list(dead)

    def window_values(self, replica, model, metric, window_s, now):
        return [v for t, v in self.series.get((model, metric), ())
                if now - window_s <= t <= now]

    def disruption_within(self, window_s, now=None):
        return any(now - window_s <= t <= now for t in self.dead)

    def tombstoned(self):
        return ["r9:9"] if self.dead else []


def _scripted(kind):
    """One scripted fleet history: the series and the tick times."""
    t = [0.1 * i for i in range(60)]
    itl = {"m@v1": [5.0] * 60, "m@v2": [5.0] * 60}
    fin = {"m@v1": list(range(60)), "m@v2": list(range(60))}
    fail = {"m@v1": [0] * 60, "m@v2": [0] * 60}
    dead = []
    if kind == "rollback":
        itl["m@v2"] = [5.0] * 15 + [80.0] * 45
    elif kind == "fleet_burn":
        itl = {k: [5.0] * 10 + [90.0] * 50 for k in itl}
    elif kind == "hold":
        dead = [1.5]
    elif kind == "errors":
        fail = {k: [i // 2 for i in range(60)] for k in fail}
    series = {}
    for key in itl:
        series[(key, "itl_p99_ms")] = list(zip(t, itl[key]))
        series[(key, "ttft_p99_ms")] = [(x, 7.0) for x in t]
        series[(key, "finished")] = list(zip(t, fin[key]))
        series[(key, "failed")] = list(zip(t, fail[key]))
    return _ScriptedCollector(series, dead), t


@pytest.mark.parametrize("kind,act", [
    ("promote", True), ("rollback", True), ("fleet_burn", True),
    ("hold", True), ("errors", True), ("rollback", False)])
def test_slo_verdicts_and_trails_equal_across_packages(kind, act):
    """Both packages' engines over one scripted series, ticked at the
    same instants: the same verdict each tick, the same ramp state,
    pushes and floor, and the same trail and snapshot once the wall
    clock's stamps are left out."""
    import brpc_tpu.serving.slo as J
    import brpc_tpu_torch.serving.slo as P
    out = {}
    for name, mod in (("jax", J), ("port", P)):
        col, times = _scripted(kind)
        objs = [mod.Objective("itl_p99_ms", 20.0),
                mod.Objective("ttft_p99_ms", 50.0)]
        if kind == "errors":
            objs.append(mod.Objective("error_rate", 0.1))
        eng = mod.SLOEngine("m", "m@v1", "m@v2", objs,
                            short_window_s=0.5, long_window_s=1.2,
                            clean_windows=8, act=act)
        r = _FakeRouter()
        verdicts = [(eng.tick(col, r, now=x), eng.floor())
                    for x in times[3:]]
        snap = eng.snapshot()
        for e in snap["trail"]:
            e.pop("t")
        snap["last_eval"].pop("t")
        out[name] = {"verdicts": verdicts, "state": eng.state,
                     "pushes": r.pushes, "snapshot": snap}
    assert out["port"] == out["jax"]
    want = {("promote", True): PROMOTED, ("rollback", True): ROLLED_BACK,
            ("rollback", False): RAMPING}.get((kind, act))
    if want is not None:
        assert out["port"]["state"] == want


def _console_get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        assert r.status == 200, (path, r.status)
        return r.read().decode()
    finally:
        c.close()


def test_fleet_page_and_families_timing_free_fields_equal_reference():
    """The same router state in both packages -- a scoreboard, canary
    picks, collector samples, an attached SLO engine ticked once --
    renders the same timing-free ``/fleet`` fields and the same fleet
    families on ``/brpc_metrics``."""
    import brpc_tpu as jbrpc
    import brpc_tpu.serving as jserving
    import brpc_tpu_torch.serving as pserving
    pk = {"jax": (jbrpc.Server, jserving), "port": (rpc.Server, pserving)}
    pages, families = {}, {}
    for name, (server_cls, serving) in pk.items():
        router = serving.ClusterRouter(
            ["127.0.0.1:1", "127.0.0.1:2"], page_tokens=4,
            auto_tick=False, telemetry_collect=False, epoch=2,
            name="tfleet_page")
        srv = server_cls()
        srv.start("127.0.0.1", 0)
        try:
            met = router.model_metrics
            for i in range(8):
                met.note_open("tfm@v1")
                met.note_ttft("tfm@v1", 0.002 * (i + 1))
                met.note_itl("tfm@v1", 0.001 * (i + 1))
                met.note_finish("tfm@v1", 0)
            met.note_open("tfm@v2")
            met.note_ttft("tfm@v2", 0.004)
            met.note_itl("tfm@v2", 0.003)
            met.note_finish("tfm@v2", 0)
            for _ in range(5):
                router.canary.pick("tfm", {"tfm@v1": 3, "tfm@v2": 1})
            for _ in range(3):
                router.collector.sample_models(met)
            eng = serving.SLOEngine(
                "tfm", "tfm@v1", "tfm@v2",
                [serving.Objective("itl_p99_ms", 100.0),
                 serving.Objective("ttft_p99_ms", 100.0)],
                short_window_s=60.0, long_window_s=120.0)
            router.attach_slo(eng)
            eng.tick(router.collector, None)
            page = json.loads(_console_get(srv.port, "/fleet?fmt=json"))
            fs = page["routers"]["tfleet_page"]
            for e in fs["slo"]["trail"]:
                e.pop("t")
            fs["slo"]["last_eval"].pop("t")
            col = fs["collector"]
            pages[name] = {
                "models": fs["models"], "canary": fs["canary"],
                "catalog": fs["catalog"], "slo": fs["slo"],
                "ladder": fs["ladder"], "series": fs["series"],
                "collector": {k: col[k] for k in (
                    "pulls", "pull_bytes", "pull_errors", "tombstones",
                    "series", "fleet_spans")}}
            html_page = _console_get(srv.port, "/fleet")
            assert "slo: tfm" in html_page and "decision trail" in html_page
            families[name] = sorted(
                line for line in _console_get(
                    srv.port, "/brpc_metrics").splitlines()
                if line.startswith("brpc_fleet_") and "tfm" in line)
        finally:
            router.close(timeout_s=1.0)
            srv.stop()
            srv.join()
    assert pages["port"] == pages["jax"]
    assert families["port"] == families["jax"]
    assert 'brpc_fleet_slo_state{model="tfm",state="ramping"} 1' in \
        families["port"]
