"""The port's parameter-server shards, service and client held against
the JAX package's, on the CPU.

  * the ownership map and the seeded table: ``shard_bounds``,
    ``owners_for`` and ``init_embedding_table`` byte-equal to the
    reference's;
  * a port fleet (EmbeddingShardServer + ``register_psserve`` on a port
    ``Server`` per shard, a ``PartitionChannel`` and a ``PSClient`` in
    front) at partitions {1, 2, 4} and a reference fleet, driven by the
    same seeded Lookup / Update / update(optimizer) sequence, end on
    equal rows and slots: plain scatter-add and sgdm bit-equal on
    integer-valued data, Adam within rtol 1e-6 (``b ** t`` may round
    differently in the two frameworks' f32 ``pow``);
  * the shared TRPC wire both ways: a port PSClient over reference
    shards and a reference PSClient over port shards;
  * counterparts of every ``tests/test_psserve.py`` case that does not
    touch the lowered table: dense oracle identity, dedup by update_id,
    coalescing on both wires, replica rotation under ``lb=``, the retry
    budget, the post-apply fault, dense pull/push, the snapshot,
    in-batch duplicate ids, update_id bounds, local key validation, id
    uniqueness, token replay after a partial fan-out, permanent errors
    not retried, oversize key sets; and the sticky JSON downgrade of a
    partition without the binary methods, in a mixed fleet.

Integer-valued tables and grads make every scatter order exact, so
"equal" means bit-equal.  Fleets are built once per module (the
cross-package comparison builds its own pairs); a test that writes
compares against the oracle applied to the fleet's rows as it found
them.  Fault sites are named through the port's ``fault``
constants.
"""
import threading

import numpy as np
import pytest
import torch

import brpc_tpu as ref
import brpc_tpu_torch.rpc as rpc
from brpc_tpu import psserve as RPS
from brpc_tpu.policy import health_check as RHC
from brpc_tpu.rpc.combo_channels import PartitionChannel as RPartition
from brpc_tpu.train import OptimizerSpec as ROptimizerSpec
from brpc_tpu_torch import errors, fault
from brpc_tpu_torch import psserve as PS
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.psserve import (EmbeddingShardServer, PSClient,
                                    init_embedding_table, owners_for,
                                    register_psserve, shard_bounds,
                                    unregister_psserve)
from brpc_tpu_torch.rpc.combo_channels import PartitionChannel
from brpc_tpu_torch.train import OptimizerSpec

CPU = "cpu"
V, D = 64, 8
PARTS = (1, 2, 4)
# duplicates, shard-boundary straddles (31|32 at p=2), first/last rows
KEYS = np.array([0, 5, 5, 31, 32, 63, 7, 5, 16, 48], np.int64)
BASE = np.round(init_embedding_table(V, D, seed=3) * 100)


def _int_grads(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, (n, D)).astype(np.float32)


def _scatter(table, keys, grads):
    out = np.array(table, np.float32)
    np.add.at(out, keys, grads)
    return out


class Fleet:
    """One shard per partition, each behind its own server, in one
    package (``mod``: ``rpc`` for the port, ``ref`` for the reference)."""

    def __init__(self, p, *, mod=rpc, batch=True, eager=True,
                 max_delay_us=500, lb=None, key_buckets=None, tag="f"):
        port = mod is rpc
        self.mod = mod
        self.pc = (PartitionChannel if port else RPartition)(p, lb=lb)
        self.servers, self.svcs, self.shards = [], [], []
        kw = {"key_buckets": key_buckets} if key_buckets else {}
        for i in range(p):
            if port:
                sh = EmbeddingShardServer(i, p, V, D, table=BASE,
                                          name=f"tps_{tag}", device=CPU,
                                          **kw)
                reg = register_psserve
            else:
                sh = RPS.EmbeddingShardServer(i, p, V, D, table=BASE,
                                              name=f"rps_{tag}", **kw)
                reg = RPS.register_psserve
            s = mod.Server()
            self.svcs.append(reg(s, sh, batch=batch, eager=eager,
                                 max_delay_us=max_delay_us,
                                 name=f"{tag}_{'t' if port else 'r'}{i}"))
            s.start("127.0.0.1", 0)
            self.servers.append(s)
            self.shards.append(sh)
            # channel-level retry off: the partition-level retry heals
            self.pc.add_partition(
                i, mod.Channel(f"127.0.0.1:{s.port}", timeout_ms=5000,
                               max_retry=0),
                endpoint=f"127.0.0.1:{s.port}")
        self.cli = (PSClient if port else RPS.PSClient)(
            self.pc, vocab=V, dim=D)

    def rows(self):
        return np.concatenate([sh.snapshot_rows() for sh in self.shards])

    def slots(self, name):
        return np.concatenate([sh.snapshot_slots()[name]
                               for sh in self.shards])

    def close(self):
        unregister = unregister_psserve if self.mod is rpc \
            else RPS.unregister_psserve
        for svc in self.svcs:
            unregister(svc)
        for srv in self.servers:
            srv.stop()
            srv.join()
        self.pc.close()


@pytest.fixture(scope="module")
def fleets():
    made = {}

    def get(p, mod=rpc):
        key = (p, mod is rpc)
        if key not in made:
            made[key] = Fleet(p, mod=mod, tag=f"m{p}")
        return made[key]

    yield get
    for f in made.values():
        f.close()
    HC.reset_all()
    RHC.reset_all()


# ---- ownership map and seeded table ----

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_shard_bounds_equal_reference(n):
    b = shard_bounds(V, n)
    assert b == RPS.shard_bounds(V, n)
    assert b[0][0] == 0 and b[-1][1] == V
    sizes = [h - lo for lo, h in b]
    assert max(sizes) - min(sizes) <= 1
    keys = np.arange(0, V, 3)
    np.testing.assert_array_equal(owners_for(keys, b),
                                  RPS.owners_for(keys, b))


def test_owners_for_straddle_and_dups():
    owner = owners_for(np.array([0, 15, 16, 31, 32, 63, 16]),
                       shard_bounds(V, 4))
    assert owner.tolist() == [0, 0, 1, 1, 2, 3, 1]


@pytest.mark.parametrize("seed", [0, 3])
def test_init_embedding_table_byte_equal(seed):
    assert init_embedding_table(V, D, seed).tobytes() == \
        RPS.init_embedding_table(V, D, seed).tobytes()


# ---- shard server (direct, no RPC) ----

def test_shard_needs_a_card_unless_told_and_refuses_mesh(monkeypatch):
    with pytest.raises(ValueError, match="item 9"):
        EmbeddingShardServer(0, 1, V, D, mesh=object(), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingShardServer(0, 1, V, D)


@pytest.mark.parametrize("p", PARTS)
def test_shard_servers_match_oracle(p):
    table = init_embedding_table(V, D, seed=3)
    grads = _int_grads(KEYS.size)
    shards = [EmbeddingShardServer(i, p, V, D, seed=3, device=CPU)
              for i in range(p)]
    owner = owners_for(KEYS, shard_bounds(V, p))
    rows = np.empty((KEYS.size, D), np.float32)
    for s in range(p):
        pos = np.flatnonzero(owner == s)
        if pos.size:
            r, _ = shards[s].lookup(KEYS[pos])
            rows[pos] = r
    np.testing.assert_array_equal(rows, table[KEYS])
    for s in range(p):
        pos = np.flatnonzero(owner == s)
        if pos.size:
            ver, dup = shards[s].update(KEYS[pos], grads[pos],
                                        update_id=100 + s)
            assert not dup and ver == 1
    got = np.concatenate([sh.snapshot_rows() for sh in shards])
    np.testing.assert_array_equal(got, _scatter(table, KEYS, grads))


def test_shard_update_idempotent_by_update_id():
    sh = EmbeddingShardServer(0, 1, V, D, seed=3, device=CPU)
    grads = _int_grads(3, seed=5)
    keys = np.array([1, 2, 1], np.int64)
    v1, dup1 = sh.update(keys, grads, update_id=42)
    before = sh.snapshot_rows()
    v2, dup2 = sh.update(keys, grads, update_id=42)   # retried sub-call
    assert (v1, dup1) == (1, False)
    assert (v2, dup2) == (1, True)        # original version, no re-add
    assert sh.version == 1
    np.testing.assert_array_equal(sh.snapshot_rows(), before)
    with pytest.raises(ValueError):       # unowned keys
        EmbeddingShardServer(1, 2, V, D, seed=3, device=CPU).lookup(
            np.array([0], np.int64))


def test_intra_batch_duplicate_update_ids_apply_once():
    """A retry can land in the SAME coalesced batch as its original:
    dedup works within the batch, on both packings, against one
    applied set."""
    sh = EmbeddingShardServer(0, 1, V, D, table=BASE, key_buckets=(8,),
                              device=CPU)
    grads = _int_grads(2, seed=13)
    keys = np.array([4, 9], np.int64)
    before = sh.snapshot_rows()
    row = EmbeddingShardServer.pack_update(777, keys, grads)
    other = EmbeddingShardServer.pack_update(778, keys, grads)
    Lb = sh.update_length_buckets()[0]
    padded = np.zeros((4, Lb), np.float64)
    padded[0, :len(row)] = row
    padded[1, :len(row)] = row        # the in-window retry
    padded[2, :len(other)] = other    # an unrelated update
    acks = sh.update_batch_fn(padded)
    assert acks[0].tolist() == [1.0, 0.0]
    assert acks[1].tolist() == [1.0, 1.0]
    assert acks[2].tolist() == [2.0, 0.0]
    assert sh.version == 2 and sh.n_dup_updates == 1
    want = _scatter(before, keys, grads * 2.0)
    np.testing.assert_array_equal(sh.snapshot_rows(), want)
    # the byte-record packing of the same retry: served from the set
    rec = EmbeddingShardServer.pack_update_record(777, keys, grads)
    Lr = sh.update_record_buckets()[0]
    padded = np.zeros((2, Lr), np.uint8)
    padded[0, :len(rec)] = rec
    acks = sh.update_batch_fn_binary(padded)
    assert acks[0].tolist() == [1.0, 1.0]
    np.testing.assert_array_equal(sh.snapshot_rows(), want)


# ---- the port fleet against the reference fleet ----

SGDM = ("sgdm", dict(lr=0.5, momentum=0.5))
ADAM = ("adam", dict(lr=0.5, beta1=0.5, beta2=0.75, eps=1.0))


@pytest.mark.parametrize("p", PARTS)
def test_fleet_equals_reference_fleet(p):
    """The same seeded sequence through a port fleet and a reference
    fleet (each over its own package's wire) ends on equal rows and
    slots, and every ack and lookup on the way is equal."""
    tf, rf = Fleet(p, tag=f"eq{p}"), Fleet(p, mod=ref, tag=f"eq{p}")
    try:
        rng = np.random.default_rng(40 + p)
        for opt in (None, SGDM, SGDM, ADAM, None, ADAM):
            keys = rng.integers(0, V, size=11).astype(np.int64)
            grads = _int_grads(11, seed=int(rng.integers(1 << 30)))
            topt = ropt = None
            if opt is not None:
                topt = OptimizerSpec(opt[0], **opt[1])
                ropt = ROptimizerSpec(opt[0], **opt[1])
            assert tf.cli.update(keys, grads, optimizer=topt) == \
                rf.cli.update(keys, grads, optimizer=ropt)
            np.testing.assert_array_equal(tf.cli.lookup(KEYS),
                                          rf.cli.lookup(KEYS))
        # rows, m and v went through Adam: rtol 1e-6; t exact
        np.testing.assert_allclose(tf.rows(), rf.rows(), rtol=1e-6,
                                   atol=0)
        for name, rtol in (("m", 1e-6), ("v", 1e-6), ("t", 0)):
            np.testing.assert_allclose(tf.slots(name), rf.slots(name),
                                       rtol=rtol, atol=0, err_msg=name)
        assert tf.cli.n_stale_reads == rf.cli.n_stale_reads == 0
        assert [sh.version for sh in tf.shards] == \
            [sh.version for sh in rf.shards]
    finally:
        tf.close()
        rf.close()


@pytest.mark.parametrize("direction", ["port_client_reference_shards",
                                       "reference_client_port_shards"])
def test_cross_package_wire(direction, fleets):
    """A PSClient of one package drives the other package's shards over
    the shared TRPC wire (tensorframe LookupT/UpdateT): lookups equal
    the target fleet's rows, updates land exactly once."""
    port_client = direction.startswith("port")
    target = fleets(2, ref if port_client else rpc)
    mod = rpc if port_client else ref
    pc = (PartitionChannel if port_client else RPartition)(2)
    for i, s in enumerate(target.servers):
        pc.add_partition(i, mod.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=5000, max_retry=0),
                         endpoint=f"127.0.0.1:{s.port}")
    cli = (PSClient if port_client else RPS.PSClient)(pc, vocab=V, dim=D)
    before = target.rows()
    np.testing.assert_array_equal(cli.lookup(KEYS), before[KEYS])
    grads = _int_grads(KEYS.size, seed=31)
    vers = [sh.version for sh in target.shards]
    acks = cli.update(KEYS, grads)
    assert acks == {i: v + 1 for i, v in enumerate(vers)}
    want = _scatter(before, KEYS, grads)
    np.testing.assert_array_equal(target.rows(), want)
    np.testing.assert_array_equal(cli.lookup(KEYS), want[KEYS])
    assert cli.n_stale_reads == 0
    assert cli.stats()["wire_modes"] == {}     # no downgrade to json


# ---- the RPC fan-out path on the port ----

@pytest.mark.parametrize("p", PARTS)
def test_psclient_bit_identical_through_rpc(p, fleets):
    f = fleets(p)
    before = f.rows()
    grads = _int_grads(KEYS.size)
    np.testing.assert_array_equal(f.cli.lookup(KEYS), before[KEYS])
    f.cli.update(KEYS, grads)
    want = _scatter(before, KEYS, grads)
    np.testing.assert_array_equal(f.rows(), want)
    # read-your-writes through the service
    np.testing.assert_array_equal(f.cli.lookup(KEYS), want[KEYS])
    assert f.cli.n_stale_reads == 0


@pytest.fixture(scope="module")
def windowed():
    """eager=False: the WINDOWED coalescing policy (eager cut-through
    makes batch counts timing-dependent)."""
    f = Fleet(2, eager=False, max_delay_us=20_000, tag="win")
    yield f
    f.close()


@pytest.mark.parametrize("serializer", ["json", "tensorframe"])
def test_update_batcher_coalesces_and_applies_exactly_once(serializer,
                                                           windowed):
    f = windowed
    before = f.rows()
    v0 = f.shards[0].version
    ub = f.svcs[0]._update_b if serializer == "json" \
        else f.svcs[0]._update_tb
    done0, batches0 = ub.n_completed.get_value(), ub.n_batches.get_value()
    n_updates, n_threads = 4, 8
    grads = _int_grads(2, seed=9)
    keys = np.array([3, 9], np.int64)     # both on partition 0

    def worker():
        c = PSClient(f.pc, vocab=V, dim=D, serializer=serializer)
        for _ in range(n_updates):
            c.update(keys, grads)

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    total = n_threads * n_updates
    assert f.shards[0].version - v0 == total
    np.testing.assert_array_equal(
        f.rows(), _scatter(before, keys, grads * float(total)))
    assert ub.n_completed.get_value() - done0 == total
    assert ub.n_batches.get_value() - batches0 < total


def test_lookup_batcher_coalesces_mixed_key_counts(windowed):
    f = windowed
    rows0 = f.rows()
    results = {}

    def one(i, n):
        c = PSClient(f.pc, vocab=V, dim=D)
        ks = (np.arange(n, dtype=np.int64) * 7 + i) % V
        results[i] = (ks, c.lookup(ks))

    ts = [threading.Thread(target=one, args=(i, n))
          for i, n in enumerate((3, 8, 17, 5, 30, 2))]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert len(results) == 6
    for ks, rows in results.values():
        np.testing.assert_array_equal(rows, rows0[ks])
    batches = sum(s._lookup_b.n_batches.get_value() for s in f.svcs)
    done = sum(s._lookup_b.n_completed.get_value() for s in f.svcs)
    assert done >= 6 and batches < done


def test_partition_retry_rotates_replica_under_lb(fleets):
    """Two replicas per partition, one dead: the fan-out retries the
    OTHER replica and the call succeeds."""
    f = fleets(2)
    pc = PartitionChannel(2, lb="rr")
    for i, s in enumerate(f.servers):
        pc.add_partition(i, rpc.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=5000, max_retry=0),
                         endpoint=f"127.0.0.1:{s.port}")
        pc.add_partition(i, rpc.Channel("127.0.0.1:1", timeout_ms=300,
                                        max_retry=0),
                         endpoint="127.0.0.1:1")
    cli = PSClient(pc, vocab=V, dim=D)
    rows0 = f.rows()
    for _ in range(4):
        np.testing.assert_array_equal(cli.lookup(KEYS), rows0[KEYS])
    picked = pc.pick(0)
    assert picked is not None
    pc.feedback(0, picked[2], 0, 100)
    HC.reset_all()


def test_retry_budget_exceeds_replica_count_via_rotation_reset():
    """A partition whose replicas ALL failed transiently keeps retrying
    up to max_retry+1 attempts: the exclusion set resets once every
    replica was tried."""
    calls = {"n": 0}

    class Flaky(rpc.Service):
        NAME = "FlakyPS"

        @rpc.method(request="json", response="json")
        def Get(self, cntl, req):
            calls["n"] += 1
            if calls["n"] <= 3:
                cntl.set_failed(errors.EINTERNAL, "transient")
                return None
            return {"ok": True}

    svc = Flaky()       # ONE instance behind both replicas
    servers = []
    pc = PartitionChannel(1, lb="rr")
    for _ in range(2):
        s = rpc.Server()
        s.add_service(svc)
        s.start("127.0.0.1", 0)
        servers.append(s)
        pc.add_partition(0, rpc.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=2000, max_retry=0),
                         endpoint=f"127.0.0.1:{s.port}")
    try:
        out = pc.call_partitioned("FlakyPS", "Get", {0: {}},
                                  timeout_ms=2000, max_retry=3)
        assert out[0]["ok"] is True
        assert calls["n"] == 4
    finally:
        for srv in servers:
            srv.stop()
            srv.join()
        pc.close()


def test_injected_post_apply_fault_retries_without_double_add(fleets):
    """The ack drops AFTER the apply; the client's retried sub-call
    dedups by update_id."""
    f = fleets(2)
    before = f.rows()
    vers = [sh.version for sh in f.shards]
    dups = sum(sh.n_dup_updates for sh in f.shards)
    retries = f.cli.n_retries
    grads = _int_grads(KEYS.size, seed=11)
    plan = fault.FaultPlan(seed=0).on(
        fault.PS_UPDATE, fault.ERROR, times=1,
        match=lambda ctx: ctx.get("stage") == "post")
    with fault.injected(plan):
        f.cli.update(KEYS, grads)
    assert plan.injected[fault.PS_UPDATE] == 1
    np.testing.assert_array_equal(f.rows(), _scatter(before, KEYS, grads))
    assert f.cli.n_retries > retries
    assert sum(sh.n_dup_updates for sh in f.shards) > dups
    assert [sh.version - v for sh, v in zip(f.shards, vers)] == [1, 1]


def test_dense_pull_push_idempotent(fleets):
    f = fleets(2)
    owner = f.cli._owner_of("w_out")
    f.shards[owner]._dense["w_out"] = np.zeros((4,), np.float32)
    ver = f.cli.push("w_out", np.ones((4,), np.float32))
    assert ver == f.shards[owner].version
    np.testing.assert_array_equal(f.cli.pull("w_out"),
                                  np.ones((4,), np.float32))
    with pytest.raises(errors.RpcError) as ei:
        f.cli.pull("nope")      # a definite error, not a hang
    assert ei.value.code == errors.ENODATA


def test_push_dedups_by_update_id():
    sh = EmbeddingShardServer(0, 1, V, D, device=CPU)
    d = np.ones((3,), np.float32)
    assert sh.push("w", d, update_id=9) == (1, False)
    assert sh.push("w", d, update_id=9) == (1, True)
    np.testing.assert_array_equal(sh.pull("w"), d)
    with pytest.raises(ValueError):
        sh.push("w", np.ones((4,), np.float32))
    with pytest.raises(KeyError):
        sh.pull("nope")


class _OldPS(PS.PSService):
    """A peer from before the binary wire: no LookupT/UpdateT."""
    LookupT = None
    UpdateT = None


def test_mixed_fleet_downgrades_old_peer_to_json_sticky():
    """Partition 0 answers ENOMETHOD to the binary methods: the client
    downgrades it to JSON once (sticky) while partition 1 stays on
    tensorframe, and the two groups' answers reassemble in key order."""
    pc = PartitionChannel(2)
    servers, shards = [], []
    for i in range(2):
        sh = EmbeddingShardServer(i, 2, V, D, table=BASE, device=CPU,
                                  name="tps_old")
        s = rpc.Server()
        if i == 0:
            s.add_service(_OldPS(sh))
        else:
            register_psserve(s, sh, batch=False)
        s.start("127.0.0.1", 0)
        servers.append(s)
        shards.append(sh)
        pc.add_partition(i, rpc.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=5000, max_retry=0),
                         endpoint=f"127.0.0.1:{s.port}")
    cli = PSClient(pc, vocab=V, dim=D)
    try:
        np.testing.assert_array_equal(cli.lookup(KEYS), BASE[KEYS])
        grads = _int_grads(KEYS.size, seed=4)
        cli.update(KEYS, grads)
        cli.update(KEYS, grads)
        want = _scatter(BASE, KEYS, grads * 2.0)
        np.testing.assert_array_equal(cli.lookup(KEYS), want[KEYS])
        st = cli.stats()
        assert st["wire_modes"] == {0: "json"}
        assert st["negotiation_fallbacks"] == 1
        assert [sh.version for sh in shards] == [2, 2]
    finally:
        for srv in servers:
            srv.stop()
            srv.join()


class _Table:
    vocab, dim = V, D


def test_local_table_registry_matches_geometry():
    table = _Table()
    PS.register_local_table(table, name="t_reg")
    try:
        assert PS.find_local_table("t_reg", V, D) is table
        assert PS.find_local_table("t_reg", V, D + 1) is None
        assert PS.find_local_table("other", V, D) is None
    finally:
        PS.unregister_local_table("t_reg")
    assert PS.find_local_table("t_reg", V, D) is None


def test_psserve_snapshot_renders(fleets):
    f = fleets(2)
    f.cli.lookup(KEYS)
    snap = PS.psserve_snapshot()
    ours = [s for s in snap["shards"] if s["name"] == f.shards[0].name
            and s["shard_index"] == 0]
    assert len(ours) == 1 and ours[0]["rows"] == 32
    assert ours[0]["device"] == "cpu"
    assert any("batchers" in s for s in snap["shards"])
    assert any(c["lookups"] >= 1 for c in snap["clients"])
    assert all(s["hot_keys"] == sorted(s["hot_keys"],
                                       key=lambda kv: -kv[1])
               for s in snap["shards"])
    assert snap["wire"]["requests_tensorframe"] > 0


def test_service_rejects_out_of_range_update_ids(fleets):
    """update_id=0 is the batch-padding sentinel: a wire caller sending
    it gets EREQUEST, never a success-shaped ack."""
    f = fleets(1)
    v0 = f.shards[0].version
    ch = rpc.Channel(f"127.0.0.1:{f.servers[0].port}", timeout_ms=5000,
                     max_retry=0)
    for bad in (0, -3, (1 << 53) + 2, "nope"):
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("PS", "Update",
                         {"keys": [1], "grads": [[0.0] * D],
                          "update_id": bad}, serializer="json")
        assert ei.value.code == errors.EREQUEST, bad
    assert f.shards[0].version == v0
    r = ch.call_sync("PS", "Update",
                     {"keys": [1], "grads": [[0.0] * D],
                      "update_id": 1 << 53}, serializer="json")
    assert r["version"] == v0 + 1 and not r["duplicate"]


def test_client_validates_keys_and_backend_locally(fleets):
    f = fleets(2)
    retries = f.cli.n_retries
    for bad in (np.array([-1], np.int64), np.array([V], np.int64)):
        with pytest.raises(ValueError):
            f.cli.update(bad, np.zeros((1, D), np.float32))
    assert f.cli.n_retries == retries
    with pytest.raises(TypeError, match="item 9"):
        PSClient(object(), vocab=V, dim=D)
    with pytest.raises(TypeError, match="item 9"):
        PSClient(f.pc, vocab=V, dim=D, ici=object())


def test_update_ids_unique_across_many_clients():
    from brpc_tpu_torch.psserve.client import _next_uid_seq
    assert len({_next_uid_seq() for _ in range(5000)}) == 5000


def test_partial_fanout_failure_token_replay_no_double_add(fleets):
    """One partition down past retries: update() raises with
    ``update_token``; replaying the SAME logical update with the token
    dedups on the partition that already applied."""
    f = fleets(2)
    before = f.rows()
    vers = [sh.version for sh in f.shards]
    grads = _int_grads(KEYS.size, seed=21)
    plan = fault.FaultPlan(seed=0).on(
        fault.PS_UPDATE, fault.ERROR, times=-1,
        match=lambda ctx: ctx.get("shard") == 1
        and ctx.get("stage") == "pre")
    with fault.injected(plan):
        with pytest.raises(errors.RpcError) as ei:
            f.cli.update(KEYS, grads)
    token = ei.value.update_token
    assert token is not None and 1 in ei.value.failed_partitions
    assert f.shards[0].version == vers[0] + 1
    dups = f.shards[0].n_dup_updates
    acks = f.cli.update(KEYS, grads, update_token=token)
    assert set(acks) == {0, 1}
    assert f.shards[0].version == vers[0] + 1, "token replay re-applied"
    assert f.shards[0].n_dup_updates == dups + 1
    assert f.shards[1].version == vers[1] + 1
    np.testing.assert_array_equal(f.rows(), _scatter(before, KEYS, grads))


def test_permanent_errors_not_retried_and_code_preserved(fleets):
    f = fleets(2)
    retries = f.cli.n_retries
    with pytest.raises(errors.RpcError) as ei:
        f.cli.pull("no_such_param")
    assert ei.value.code == errors.ENODATA
    assert f.cli.n_retries == retries


@pytest.mark.parametrize("batch", [True, False])
def test_oversize_key_set_is_erequest_not_einternal(batch, fleets):
    """More keys than the largest bucket is a bad request on both
    server paths, never an EINTERNAL retried to ETOOMANYFAILS."""
    big = np.arange(V, dtype=np.int64).repeat(10)[:600] % V   # > 512
    f = fleets(1) if batch else Fleet(1, batch=False, tag="nob")
    try:
        ch = rpc.Channel(f"127.0.0.1:{f.servers[0].port}",
                         timeout_ms=5000, max_retry=0)
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("PS", "Lookup", {"keys": big.tolist()},
                         serializer="json")
        assert ei.value.code == errors.EREQUEST
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("PS", "Update",
                         {"keys": big.tolist(),
                          "grads": [[0.0] * D] * big.size,
                          "update_id": 5}, serializer="json")
        assert ei.value.code == errors.EREQUEST
    finally:
        if not batch:
            f.close()
