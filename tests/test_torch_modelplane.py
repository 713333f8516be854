"""The port's model plane held against the JAX package's.

Counterparts of ``tests/test_modelplane.py`` over ``brpc_tpu_torch``:
deployment keys and the (model, prefix) fingerprint, the replica-side
``ReplicaDeployments`` lifecycle, the router-side ``ModelCatalog``, the
smooth-WRR ``CanarySplit``, the ``DeploymentRegistry`` manifest; the
WAL's model column; the wire (an unknown model is EREQUEST at the front
door, a replica-side misroute EINTERNAL and counted, the model-tagged
``_kvmig`` refusal, the ``router.model_route`` fault site); a two-model
fleet bit-exact with stores that never mix; adoption across a router
process's death; the lifecycle RPCs over ``_cluster``; and the arbiter's
cluster floor.  The replicas are ``rpc_press.spin_up_multimodel_*``'s:
harness-mode stores and per-model step functions on the CPU, every
stream held to ``expected_model_tokens``.

Where a primitive has the same inputs in both packages its output is
held to the JAX package's (keys, fingerprints, catalog, the canary
schedule, the registry's snapshot), and a multi-model fleet of either
package serves behind the other's router.
"""
import http.client
import json
import threading

import numpy as np
import pytest

from brpc_tpu_torch import errors, fault, rpc
from brpc_tpu_torch.tools.rpc_press import (
    expected_model_tokens, spin_up_multimodel_cluster,
    spin_up_multimodel_replicas, tear_down_multimodel_cluster,
    tear_down_multimodel_replicas)

from testutil import wait_until

CPU = "cpu"


def _reset_policy(health_check, circuit_breaker):
    health_check.reset_all()
    b = circuit_breaker.global_breaker()
    with b._mu:
        b._short.clear()
        b._long.clear()
        b._isolation_count.clear()
        b._recovering_until.clear()


@pytest.fixture(autouse=True)
def _hygiene():
    """No fault plan, broken endpoint or breaker state outlives a test
    (the JAX package's too: the cross-package test uses its router)."""
    from brpc_tpu_torch.policy import circuit_breaker, health_check
    fault.clear()
    # an earlier test's stopped server can leave its port marked broken,
    # and a replica that reuses the port would read as down
    _reset_policy(health_check, circuit_breaker)
    yield
    fault.clear()
    _reset_policy(health_check, circuit_breaker)
    from brpc_tpu.policy import circuit_breaker as jcb
    from brpc_tpu.policy import health_check as jhc
    _reset_policy(jhc, jcb)


def _cluster(*a, **kw):
    return spin_up_multimodel_cluster(*a, device=CPU, **kw)


def _replicas(*a, **kw):
    return spin_up_multimodel_replicas(*a, device=CPU, **kw)


# ---------------------------------------------------------------------------
# deployment primitives
# ---------------------------------------------------------------------------

def test_deployment_key_roundtrip():
    import brpc_tpu.serving.modelplane as J
    from brpc_tpu_torch.serving.modelplane import (deployment_key,
                                                   split_deployment_key)
    assert deployment_key("orca") == "orca"
    assert deployment_key("orca", "v2") == "orca@v2"
    assert split_deployment_key("orca") == ("orca", "")
    assert split_deployment_key("orca@v2") == ("orca", "v2")
    # a version may itself hold '@': split on the FIRST
    assert split_deployment_key("a@b@c") == ("a", "b@c")
    for k in ("orca", "orca@v2", "a@b@c"):
        assert split_deployment_key(k) == J.split_deployment_key(k)


def test_model_fingerprint_folds_model_and_keeps_default_plain():
    import brpc_tpu.serving.modelplane as J
    from brpc_tpu_torch.policy.load_balancer import prefix_fingerprint
    from brpc_tpu_torch.serving.modelplane import (DEFAULT_MODEL,
                                                   model_fingerprint)
    toks = list(range(40))
    plain = prefix_fingerprint(toks, 16)
    # the default model (and a model-less request) keep the plain prefix
    # fingerprint: one-model placement is the catalog-less ring walk
    assert model_fingerprint(None, toks) == plain
    assert model_fingerprint(DEFAULT_MODEL, toks) == plain
    # named models walk the ring from DIFFERENT points for the same
    # tokens: no page crosses models
    fa = model_fingerprint("modela", toks)
    fb = model_fingerprint("modelb", toks)
    assert fa != plain and fb != plain and fa != fb
    assert model_fingerprint("modela", toks) == fa
    for m in (None, DEFAULT_MODEL, "modela", "modelb"):
        assert model_fingerprint(m, toks) == J.model_fingerprint(m, toks)


def test_replica_deployments_lifecycle():
    from brpc_tpu_torch.serving.modelplane import (DRAINING, LOADING, WARM,
                                                   ReplicaDeployments)
    deps = ReplicaDeployments(name="t")
    eng = object()
    deps.deploy("orca@v1", engine=eng, weight=3)
    row = deps.get("orca@v1")
    assert row["state"] == LOADING and row["weight"] == 3
    assert row["model_id"] == "orca" and row["version"] == "v1"
    # the warm-up proof: a finished generation flips loading -> warm
    deps.note_generation("orca@v1")
    assert deps.get("orca@v1")["state"] == WARM
    assert deps.get("orca@v1")["generations"] == 1
    # drain: the published state changes, the bindings still resolve
    assert deps.drain("orca@v1")
    assert deps.get("orca@v1")["state"] == DRAINING
    key, bound = deps.resolve("orca@v1")
    assert key == "orca@v1" and bound["engine"] is eng
    # a re-deploy refreshes state and weight and KEEPS bindings
    deps.deploy("orca@v1", state=WARM, weight=5)
    row = deps.get("orca@v1")
    assert row["state"] == WARM and row["weight"] == 5
    assert row["engine"] is eng
    assert deps.undeploy("orca@v1")
    assert not deps.undeploy("orca@v1")
    assert len(deps) == 0


def test_replica_deployments_resolve_modelless_and_unknown():
    from brpc_tpu_torch.serving.modelplane import (DEFAULT_MODEL, WARM,
                                                   ReplicaDeployments)
    deps = ReplicaDeployments()
    deps.deploy("solo", state=WARM)
    key, _ = deps.resolve(None)          # the sole deployment
    assert key == "solo"
    deps.deploy("other", state=WARM)
    with pytest.raises(KeyError):
        deps.resolve(None)
    deps.deploy(DEFAULT_MODEL, state=WARM)
    key, _ = deps.resolve(None)
    assert key == DEFAULT_MODEL
    with pytest.raises(KeyError):        # the service's misroute path
        deps.resolve("nope")


def test_model_catalog_resolve_weights_and_drain_semantics():
    from brpc_tpu_torch.serving.modelplane import (DRAINING, LOADING, WARM,
                                                   ModelCatalog,
                                                   ReplicaDeployments)
    cat = ModelCatalog()
    d1 = ReplicaDeployments()
    d1.deploy("orca@v1", weight=95, state=WARM)
    d1.deploy("orca@v2", weight=5, state=LOADING)
    d2 = ReplicaDeployments()
    d2.deploy("orca@v1", weight=95, state=DRAINING)
    d2.deploy("solo", state=WARM)
    cat.note("r1:1", d1.snapshot())
    cat.note("r2:2", d2.snapshot())
    assert cat.resolve("orca@v1") == ["orca@v1"]
    assert sorted(cat.resolve("orca")) == ["orca@v1", "orca@v2"]
    assert cat.resolve("nope") == []
    # max across replicas, draining rows left out
    assert cat.version_weights("orca") == {"orca@v1": 95, "orca@v2": 5}
    # new placements go to warm and loading holders; a draining replica
    # still serves what it holds
    assert cat.replicas_for("orca@v1", for_new=True) == ["r1:1"]
    assert sorted(cat.replicas_for("orca@v1", for_new=False)) == \
        ["r1:1", "r2:2"]
    assert cat.replicas_for("orca@v2", for_new=True) == ["r1:1"]
    assert cat.sole_key() is None
    solo = ModelCatalog()
    solo.note("r1:1", d2.snapshot()[1:])     # just "solo"
    assert solo.sole_key() == "solo"
    # a full replace forgets what the replica no longer publishes
    d1.undeploy("orca@v2")
    cat.note("r1:1", d1.snapshot())
    assert cat.resolve("orca@v2") == []


def test_canary_split_is_deterministic_and_holds_95_5():
    import brpc_tpu.serving.modelplane as J
    from brpc_tpu_torch.serving.modelplane import CanarySplit
    weights = {"m@v1": 95, "m@v2": 5}
    a, b = CanarySplit(), CanarySplit()
    seq_a = [a.pick("m", weights) for _ in range(200)]
    seq_b = [b.pick("m", weights) for _ in range(200)]
    assert seq_a == seq_b
    # the JAX package's schedule, pick for pick
    j = J.CanarySplit()
    assert seq_a == [j.pick("m", weights) for _ in range(200)]
    picks = a.snapshot()["m"]
    share = 100.0 * picks["m@v1"] / sum(picks.values())
    assert abs(share - 95.0) <= 2.0, picks
    for lo in range(0, 101, 20):             # no bursts in any window
        window = seq_a[lo:lo + 100]
        assert 94 <= window.count("m@v1") <= 96


def test_deployment_registry_manifest_surface():
    from brpc_tpu_torch.models import (DeploymentRegistry, ModelDeployment,
                                       global_registry)
    reg = DeploymentRegistry()
    built = []

    def factory():
        built.append(1)
        return "runner"

    d = ModelDeployment("orca", "v1", runner_factory=factory,
                        weight=95, kv_geometry={"page_tokens": 16})
    reg.register(d)
    reg.register(ModelDeployment("orca", "v2", runner_factory=factory,
                                 weight=5))
    assert d.key == "orca@v1"
    assert reg.resolve("orca@v1") is d
    assert sorted(x.key for x in reg.versions_of("orca")) == \
        ["orca@v1", "orca@v2"]
    assert reg.get("nope") is None
    with pytest.raises(KeyError):
        reg.resolve("nope")
    assert d.build_runner() == "runner" and built == [1]
    snap = {r["model"]: r for r in reg.snapshot()}
    assert snap["orca@v1"]["weight"] == 95
    assert snap["orca@v1"]["kv_geometry"] == {"page_tokens": 16}
    with pytest.raises(ValueError):          # a duplicate is a bug
        reg.register(ModelDeployment("orca", "v1",
                                     runner_factory=factory))
    assert reg.unregister("orca@v1")
    assert global_registry() is global_registry()


def test_registry_snapshot_and_resolution_equal_across_packages():
    """The same registrations in both packages: equal snapshots, equal
    resolutions, equal refusals."""
    import brpc_tpu.models.registry as J
    import brpc_tpu_torch.models.registry as P

    def build(mod):
        reg = mod.DeploymentRegistry()
        reg.register(mod.ModelDeployment(
            "orca", "v1", runner_factory=lambda: None, weight=95,
            kv_geometry={"page_tokens": 16, "kv_bytes_per_token": 4096},
            meta={"seed": 1}))
        reg.register(mod.ModelDeployment("orca", "v2", weight=0))
        reg.register(mod.ModelDeployment("solo"))
        out = {"snapshot": reg.snapshot(), "keys": reg.keys(),
               "len": len(reg),
               "versions": [d.key for d in reg.versions_of("orca")]}
        for q in ("orca@v1", "solo", "orca", None, "nope"):
            try:
                out[f"resolve {q}"] = reg.resolve(q).key
            except KeyError as e:
                out[f"resolve {q}"] = f"KeyError {e}"
        reg.unregister("orca@v2")
        out["one version"] = reg.resolve("orca").key
        return out

    assert build(P) == build(J)


# ---------------------------------------------------------------------------
# the WAL's model column
# ---------------------------------------------------------------------------

def test_wal_decodes_pre_plane_records_as_default_model(tmp_path):
    """Records written before the model plane (no "m") decode as the
    default model, and default-model opens still write none."""
    from brpc_tpu_torch.butil.recordio import RecordReader, RecordWriter
    from brpc_tpu_torch.serving import SessionTable
    from brpc_tpu_torch.serving.modelplane import DEFAULT_MODEL
    from brpc_tpu_torch.serving.session_wal import (REC_OPEN, REC_SNAP,
                                                    REC_TOK, SessionWAL)
    path = str(tmp_path / "old.wal")
    with open(path, "wb") as fp:
        w = RecordWriter(fp)
        w.write(json.dumps({"s": "old1", "p": [1, 2, 3],
                            "b": 4}).encode(), REC_OPEN)
        w.write(json.dumps({"s": "old1", "c": 1, "t": 11}).encode(),
                REC_TOK)
        w.write(json.dumps({"s": "old2", "p": [5, 6], "b": 2, "e": [9],
                            "st": "running", "ec": None}).encode(),
                REC_SNAP)
        w.write(json.dumps({"s": "new1", "p": [7], "b": 2,
                            "m": "modelb"}).encode(), REC_OPEN)
        w.flush()
    table = SessionTable.recover(path)
    try:
        assert table.get("old1").model == DEFAULT_MODEL
        assert table.get("old1").emitted == [11]
        assert table.get("old2").model == DEFAULT_MODEL
        assert table.get("new1").model == "modelb"
    finally:
        table.close()
    path2 = str(tmp_path / "new.wal")
    wal = SessionWAL(path2, auto_compact=False)
    wal.append_open("s1", [1, 2], 4)
    wal.append_open("s2", [3, 4], 4, model="modelb")
    wal.close()
    with open(path2, "rb") as fp:
        bodies = [json.loads(body) for _meta, body in RecordReader(fp)]
    assert "m" not in bodies[0]
    assert bodies[1]["m"] == "modelb"


def test_wal_roundtrip_preserves_model_through_compaction(tmp_path):
    from brpc_tpu_torch.serving import SessionTable
    path = str(tmp_path / "rt.wal")
    table = SessionTable(wal=path)
    s = table.new_session([1, 2, 3], 4, model="modela@v2")
    s.append(42)
    table.close()
    adopted = SessionTable.recover(path)       # recover compacts
    try:
        r = adopted.get(s.sid)
        assert r.model == "modela@v2"
        assert r.emitted == [42] and r.state == "suspended"
    finally:
        adopted.close()
    again = SessionTable.recover(path)         # from the compacted file
    try:
        assert again.get(s.sid).model == "modela@v2"
    finally:
        again.close()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

class _Collector(rpc.StreamHandler):
    def __init__(self):
        self.done = threading.Event()
        self.tokens = []

    def on_received_messages(self, stream, messages):
        for m in messages:
            d = json.loads(m)
            if "token" in d:
                self.tokens.append(d["token"])
            if d.get("done"):
                self.done.set()

    def on_closed(self, stream):
        self.done.set()


def _http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def test_unknown_model_is_erequest_at_the_front_door():
    from brpc_tpu_torch.serving import RouterClient
    replicas, _, router, rsrv, raddr = _cluster(
        1, ["modela"], name_prefix="tmp_unknown")
    try:
        with pytest.raises(errors.RpcError) as ei:
            RouterClient(raddr, timeout_ms=5000).start([1, 2, 3], 4,
                                                       model="nope")
        assert ei.value.code == errors.EREQUEST
        assert "unknown model" in (ei.value.text or "")
        # nothing left the front door
        assert router.stats()["sessions"]["total"] == 0
        assert replicas[0]["serving"].n_model_misroutes == 0
    finally:
        tear_down_multimodel_cluster(replicas, router, rsrv)


def test_serving_misroute_is_einternal_and_counted():
    """A forwarded model the replica does not serve fails EINTERNAL (a
    failover code: the driver re-routes) and is counted; the served
    model streams, and so does its chunked HTTP generate."""
    replicas, mults = _replicas(1, ["modela"], name_prefix="tmp_misroute")
    try:
        r = replicas[0]
        ch = rpc.Channel(r["addr"], timeout_ms=5000, max_retry=0)
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("Serving", "Generate",
                         {"prompt": [1, 2], "max_new_tokens": 2,
                          "model": "modelb"}, serializer="json")
        assert ei.value.code == errors.EINTERNAL
        assert "not served by this replica" in (ei.value.text or "")
        assert r["serving"].n_model_misroutes == 1
        col = _Collector()
        cntl = rpc.Controller(timeout_ms=5000)
        rpc.stream_create(cntl, col)
        resp = ch.call_sync("Serving", "Generate",
                            {"prompt": [1, 2], "max_new_tokens": 2,
                             "model": "modela"}, serializer="json",
                            cntl=cntl)
        assert resp["accepted"] is True and resp["model"] == "modela"
        assert col.done.wait(20)
        assert col.tokens == expected_model_tokens([1, 2], 2,
                                                   mults["modela"])
        assert r["serving"].n_model_misroutes == 1
        # the HTTP face resolves ?model= through the same table
        port = r["server"].port
        status, body = _http_get(port, "/serving/generate?prompt=1,2"
                                       "&max_new_tokens=2&model=modela")
        lines = [json.loads(x) for x in body.splitlines() if x]
        assert status == 200
        assert [x["token"] for x in lines if "token" in x] == col.tokens
        status, _ = _http_get(port, "/serving/generate?prompt=1,2"
                                    "&model=modelb")
        assert status == 404
    finally:
        tear_down_multimodel_replicas(replicas)


def test_migrate_push_refuses_model_mismatch():
    """A model-tagged ``_kvmig`` owner refuses a mismatched fetch
    (EREQUEST, counted); a matching one proceeds."""
    replicas, _ = _replicas(2, ["modela"], name_prefix="tmp_mig")
    try:
        owner = replicas[0]
        mig = owner["server"]._services["_kvmig"]
        assert mig.model == "modela"
        ch = rpc.Channel(owner["addr"], timeout_ms=5000, max_retry=0)
        dest = replicas[1]["addr"]
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("_kvmig", "PushTo",
                         {"tokens": [1, 2, 3], "dest": dest,
                          "model": "modelb"}, serializer="json")
        assert ei.value.code == errors.EREQUEST
        assert "model mismatch" in (ei.value.text or "")
        assert mig.n_model_refusals == 1
        out = ch.call_sync("_kvmig", "PushTo",
                           {"tokens": [1, 2, 3], "dest": dest,
                            "model": "modela"}, serializer="json")
        assert out["migrated_pages"] == 0
        assert mig.n_model_refusals == 1
        assert mig.stats()["model_refusals"] == 1
    finally:
        tear_down_multimodel_replicas(replicas)


def test_router_model_route_fault_is_counted_and_rerouted():
    """An injected stale-catalog pick (``fault.ROUTER_MODEL_ROUTE``) is
    counted in ``wrong_model_routes`` and re-routed inside the router;
    the generation still finishes bit-exact."""
    from brpc_tpu_torch.serving import RouterClient
    replicas, mults, router, rsrv, raddr = _cluster(
        2, ["modela"], name_prefix="tmp_fault")
    try:
        plan = fault.FaultPlan(seed=7)
        plan.on(fault.ROUTER_MODEL_ROUTE, fault.ERROR, times=1)
        prompt = [10, 11, 12]
        with fault.injected(plan):
            g = RouterClient(raddr, timeout_ms=10_000).start(
                prompt, 6, model="modela")
            assert g.wait(30) and g.error is None
        assert plan.injected.get(fault.ROUTER_MODEL_ROUTE, 0) == 1
        assert g.tokens == expected_model_tokens(prompt, 6,
                                                 mults["modela"])
        assert router.stats()["wrong_model_routes"] == 1
        for r in replicas:
            assert r["serving"].n_model_misroutes == 0
    finally:
        tear_down_multimodel_cluster(replicas, router, rsrv)


def test_two_model_fleet_bit_exact_and_stores_never_mix():
    from brpc_tpu_torch.serving import RouterClient
    replicas, mults, router, rsrv, raddr = _cluster(
        2, ["modela", "modelb"], layout=[["modela"], ["modelb"]],
        page_tokens=4, commit_live_pages=True, name_prefix="tmp_2m")
    try:
        cli = RouterClient(raddr, timeout_ms=10_000)
        a_prompt = [100 + i for i in range(8)]
        b_prompt = [500 + i for i in range(8)]
        ga = cli.start(a_prompt, 6, model="modela")
        gb = cli.start(b_prompt, 6, model="modelb")
        assert ga.wait(30) and ga.error is None
        assert gb.wait(30) and gb.error is None
        assert ga.tokens == expected_model_tokens(a_prompt, 6,
                                                  mults["modela"])
        assert gb.tokens == expected_model_tokens(b_prompt, 6,
                                                  mults["modelb"])
        assert router.stats()["wrong_model_routes"] == 0
        by_model = router.sessions.counts_by_model()
        assert by_model["modela"]["finished"] == 1
        assert by_model["modelb"]["finished"] == 1
        # pages never cross the model boundary
        assert replicas[0]["stores"]["modela"].probe(b_prompt) == 0
        assert replicas[1]["stores"]["modelb"].probe(a_prompt) == 0
        for r in replicas:
            assert r["serving"].n_model_misroutes == 0
    finally:
        tear_down_multimodel_cluster(replicas, router, rsrv)


def test_wal_adoption_rebinds_sessions_to_their_model(tmp_path):
    """Sessions of BOTH models stream through a router PROCESS that is
    then SIGKILLed; a successor adopts the WAL and resumes each session
    on a replica serving its model, bit-exact, exactly once."""
    from brpc_tpu_torch.serving import (ClusterRouter, ReplicaHandle,
                                        RouterClient, SessionTable,
                                        register_router)
    from brpc_tpu_torch.serving.router_proc import spawn_router
    PT, budget = 4, 8
    replicas, mults = _replicas(
        2, ["modela", "modelb"], layout=[["modela"], ["modelb"]],
        page_tokens=PT, step_delay_s=0.03, commit_live_pages=True,
        name_prefix="tmp_adopt")
    addrs = [r["addr"] for r in replicas]
    proc, raddr = spawn_router(str(tmp_path / "sessions.wal"), addrs,
                               page_tokens=PT, check_interval_s=0.02)
    successor = rsrv2 = None
    try:
        def catalog_addrs():
            st = rpc.Channel(raddr, timeout_ms=5000).call_sync(
                "Router", "Stats", {}, serializer="json",
                response_serializer="json")
            return set(st.get("catalog") or {})
        assert wait_until(lambda: catalog_addrs() >= set(addrs), 15), \
            "the router process never learned the fleet's catalog"
        cli = RouterClient(raddr, timeout_ms=20_000)
        a_prompt = [100 + i for i in range(9)]
        b_prompt = [500 + i for i in range(9)]
        ga = cli.start(a_prompt, budget, model="modela")
        gb = cli.start(b_prompt, budget, model="modelb")
        assert ga.wait_tokens(3, timeout_s=30)
        assert gb.wait_tokens(3, timeout_s=30)
        proc.kill()
        proc.wait()
        held = []
        for prompt, m, g in ((a_prompt, "modela", ga),
                             (b_prompt, "modelb", gb)):
            g.drop()
            held.append((prompt, m, g.session_id, g.cursor, g.tokens))
        table = SessionTable.recover(str(tmp_path / "sessions.wal"))
        for _p, m, sid, _c, _t in held:
            assert table.get(sid).model == m
        successor = ClusterRouter(
            [ReplicaHandle(r["addr"], deployments=r["deps"])
             for r in replicas],
            sessions=table, page_tokens=PT, check_interval_s=0.02,
            name="tmp_adopt_successor")
        rsrv2 = rpc.Server()
        register_router(rsrv2, successor)
        rsrv2.start("127.0.0.1", 0)
        cli2 = RouterClient(f"127.0.0.1:{rsrv2.port}", timeout_ms=30_000)
        for i, (prompt, m, sid, cursor, seen) in enumerate(held):
            out = cli2.resume_wait(sid, cursor, timeout_s=60)
            assert out["error"] is None, f"{m} resume failed"
            full = seen[:cursor] + out["tokens"]
            assert full == expected_model_tokens(prompt, budget, mults[m])
            assert table.get(sid).replica == replicas[i]["addr"]
        assert successor.stats()["wrong_model_routes"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if successor is not None:
            successor.close(timeout_s=2.0)
            successor.sessions.close()
        if rsrv2 is not None:
            rsrv2.stop()
            rsrv2.join()
        tear_down_multimodel_replicas(replicas)


def test_cluster_deploy_rpcs_mutate_and_publish():
    from brpc_tpu_torch.serving.modelplane import (DRAINING, WARM,
                                                   cluster_deploy,
                                                   parse_deployments)
    replicas, _ = _replicas(1, ["modela"], name_prefix="tmp_life")
    r = replicas[0]
    try:
        out = cluster_deploy(r["addr"], epoch=1, model="newb",
                             op="deploy", weight=4, state="warm")
        assert out["applied"] and out["epoch"] == 1
        rows = {x["model"]: x
                for x in parse_deployments(out["deployments"])}
        assert rows["newb"]["state"] == WARM
        assert rows["newb"]["weight"] == 4
        assert r["deps"].get("newb")["engine"] is None
        cluster_deploy(r["addr"], epoch=1, model="newb", op="drain")
        assert r["deps"].get("newb")["state"] == DRAINING
        cluster_deploy(r["addr"], epoch=1, model="newb", op="undeploy")
        assert r["deps"].get("newb") is None
        with pytest.raises(errors.RpcError) as ei:
            cluster_deploy(r["addr"], epoch=1, model="ghost", op="drain")
        assert ei.value.code == errors.EREQUEST
        # a superseded router's push bounces off the epoch fence
        with pytest.raises(errors.RpcError) as ei:
            cluster_deploy(r["addr"], epoch=0, model="modela", op="drain")
        assert ei.value.code == errors.EREQUEST
        assert "stale epoch" in (ei.value.text or "")
        ctrl = r["server"]._services["_cluster"]
        assert ctrl.deploy_ops == 3
        assert ctrl.deploy_refusals == 1
    finally:
        tear_down_multimodel_replicas(replicas)


# ---------------------------------------------------------------------------
# the trainer tier: the cluster floor holds waves fleet-wide
# ---------------------------------------------------------------------------

def test_arbiter_cluster_floor_holds_waves_cheapest_first():
    """A router-pushed floor >= 1 raises the arbiter's effective level
    to shed_trainer while its own ladder stays calm: waves hold, and no
    serving rung fires."""
    from brpc_tpu_torch.train.arbiter import TrafficArbiter
    floor = [0]
    arb = TrafficArbiter(tick_interval_s=0.01, pace_delay_s=0.01,
                         shed_poll_s=0.01, shed_timeout_s=5.0,
                         name="tmp_arb",
                         cluster_floor_sources=[lambda: floor[0]])
    assert arb.effective_level() == 0
    assert arb.admit_wave() is False
    floor[0] = 1
    assert arb.ladder.level == 0
    assert arb.effective_level() == 2
    done = threading.Event()
    delayed = []

    def wave():
        delayed.append(arb.admit_wave())
        done.set()

    t = threading.Thread(target=wave, daemon=True)
    t.start()
    assert not done.wait(0.15)                 # held while the floor stands
    assert arb.n_cluster_held_waves == 1
    floor[0] = 0
    assert done.wait(5), "the wave was never released"
    t.join(5)
    assert delayed == [True]
    st = arb.stats()
    assert st["cluster_held_waves"] == 1 and st["shed_waves"] == 1
    assert st["brownouts"] == 0 and st["clamps"] == 0
    assert st["cluster_floor"] == 0
    # a dead floor source reads 0: it never wedges the trainer
    arb.add_cluster_floor_source(lambda: 1 / 0)
    assert arb.cluster_floor() == 0
    assert arb.effective_level() == 0


# ---------------------------------------------------------------------------
# the two packages together
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router_pkg,replica_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_multimodel_router_of_one_package_in_front_of_replicas_of_the_other(
        router_pkg, replica_pkg):
    """Two models on two replicas of one package behind the other
    package's router: each model's stream equals its oracle, and no
    witness counts a wrong-model route."""
    import brpc_tpu as jbrpc
    import brpc_tpu.serving as jserving
    from brpc_tpu.tools import rpc_press as jpress

    import brpc_tpu_torch.serving as pserving
    from brpc_tpu_torch.tools import rpc_press as ppress
    pk = {"jax": (jbrpc.Server, jserving, jpress, {}),
          "port": (rpc.Server, pserving, ppress, {"device": CPU})}
    server_cls, serving, _, _ = pk[router_pkg]
    _, _, press, kw = pk[replica_pkg]
    replicas, mults = press.spin_up_multimodel_replicas(
        2, ["modela", "modelb"], page_tokens=4,
        name_prefix=f"tmp_x{router_pkg}", **kw)
    # address-only handles: the catalog arrives over _cluster
    router = serving.ClusterRouter(
        [r["addr"] for r in replicas], page_tokens=4,
        check_interval_s=0.02, name=f"tmp_x{router_pkg}_router")
    rsrv = server_cls()
    serving.register_router(rsrv, router)
    rsrv.start("127.0.0.1", 0)
    try:
        assert wait_until(lambda: len(router.catalog.replicas_for(
            "modelb", for_new=True)) == 2, 15)
        cli = serving.RouterClient(f"127.0.0.1:{rsrv.port}",
                                   timeout_ms=10_000)
        for m, base in (("modela", 100), ("modelb", 500), ("modela", 300)):
            prompt = [base + i for i in range(7)]
            out = cli.generate(prompt, 6, timeout_s=20, model=m)
            assert out["error"] is None
            assert out["tokens"] == press.expected_model_tokens(
                prompt, 6, mults[m])
            # the other package's oracle is the same function
            other = ppress if press is jpress else jpress
            assert out["tokens"] == other.expected_model_tokens(
                prompt, 6, mults[m])
        assert router.stats()["wrong_model_routes"] == 0
        assert all(r["serving"].n_model_misroutes == 0 for r in replicas)
    finally:
        router.close(timeout_s=3.0)
        rsrv.stop()
        rsrv.join()
        press.tear_down_multimodel_replicas(replicas)


def test_multimodel_helpers_equal_reference():
    """The step rules, their oracle and the per-model multipliers are
    the JAX package's."""
    from brpc_tpu.tools import rpc_press as jpress
    from brpc_tpu_torch.tools import rpc_press as ppress
    assert ppress.MODEL_STEP_PRIMES == jpress.MODEL_STEP_PRIMES
    rng = np.random.default_rng(3)
    for mult in ppress.MODEL_STEP_PRIMES:
        prompt = rng.integers(0, 997, 5).tolist()
        assert ppress.expected_model_tokens(prompt, 9, mult) == \
            jpress.expected_model_tokens(prompt, 9, mult)
        step = ppress.model_step_fn(mult)
        toks, pos = np.arange(10), np.arange(10, 20)
        np.testing.assert_array_equal(
            step(toks, pos), jpress.model_step_fn(mult)(toks, pos))
    a = ppress.zipf_key_sampler(64, 1.0, seed=5)(32)
    b = jpress.zipf_key_sampler(64, 1.0, seed=5)(32)
    np.testing.assert_array_equal(a, b)
