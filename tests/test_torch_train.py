"""The port's training plane held against the JAX package's, on the CPU.

  * ``OptimizerSpec``: validation, the json and tensorframe-field round
    trips, and wire forms equal to the reference's;
  * ``fused_apply`` / ``oracle_apply``, sgdm and Adam, against the
    reference's on the same inputs: integer-valued data bit-equal,
    random data within 1e-6 of each array's largest magnitude (two
    frameworks' f32 scatter-add order and ``pow``; an entry that
    cancels to near zero keeps the absolute error of its operands);
  * the fused co-located optimizer through ``PS.Update`` at partitions
    {1, 2, 4}: rows and slots bit-equal to the port's dense oracle
    (duplicate keys, bucket padding and per-row Adam step counts
    included);
  * a retried wave after the ``PS_OPT_APPLY`` post-apply fault steps
    momentum exactly once;
  * the trainer's loss and ``(g_rows, g_dense)`` against
    ``jax.value_and_grad`` of the reference trainer's ``loss_from_rows``
    on the same numpy rows, params and targets, in bf16: the loss
    within 2^-8 of its value (one bf16 ulp), each gradient within 2^-6
    of its largest magnitude (the two frameworks round their bf16
    products at different points);
  * ``DataParallelTrainer`` through the wire: the loss falls (both
    modes), injected ``UPDATE_WAVE`` faults heal exactly once, and the
    bounded-staleness gate excuses a dead worker;
  * ``examples/embedding_server.py`` trains through two shards.

Integer-valued tables and grads keep every comparison exact where it
says bit-equal.  Fault sites are named through the port's ``fault``
constants.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brpc_tpu_torch.rpc as rpc
import brpc_tpu_torch.train as train
from brpc_tpu.models.parameter_server import PSConfig as RPSConfig
from brpc_tpu.train import optimizer as RO
from brpc_tpu.train.trainer import DataParallelTrainer as RTrainer
from brpc_tpu_torch import errors, fault
from brpc_tpu_torch.models.parameter_server import PSConfig
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.psserve import (EmbeddingShardServer, PSClient,
                                    init_embedding_table, register_psserve,
                                    unregister_psserve)
from brpc_tpu_torch.rpc.combo_channels import PartitionChannel
from brpc_tpu_torch.train import OptimizerSpec, oracle_apply
from brpc_tpu_torch.train import optimizer as TO
from brpc_tpu_torch.train.trainer import (DataParallelTrainer,
                                          loss_and_grads_from_rows)

CPU = "cpu"
V, D = 48, 8
SPECS = {"sgdm": dict(lr=0.5, momentum=0.5),
         "adam": dict(lr=0.5, beta1=0.5, beta2=0.75, eps=1.0)}


def _int_table(seed=3):
    # integer-valued float32 everywhere: float addition is exact, so
    # bit-identity claims are order-proof
    return np.round(init_embedding_table(V, D, seed=seed) * 100)


def _int_grads(rng, n):
    return rng.integers(-3, 4, (n, D)).astype(np.float32)


def _close(got, want, rel):
    """Equal within ``rel`` of ``want``'s largest magnitude."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _cfg(cls=PSConfig):
    return cls(vocab=V, d_model=D, d_ff=2 * D, n_layers=2, seq=8, batch=4)


class _Fleet:
    def __init__(self, n_shards, table, tag):
        self.shards, self.servers, self.svcs = [], [], []
        self.pc = PartitionChannel(n_shards)
        for i in range(n_shards):
            sh = EmbeddingShardServer(i, n_shards, V, D, table=table,
                                      name=f"tt_{tag}", device=CPU)
            self.shards.append(sh)
            s = rpc.Server()
            self.svcs.append(register_psserve(s, sh, name=f"tt_{tag}_{i}"))
            s.start("127.0.0.1", 0)
            self.servers.append(s)
            self.pc.add_partition(i, rpc.Channel(f"127.0.0.1:{s.port}",
                                                 timeout_ms=5000))

    def client(self, max_retry=2):
        return PSClient(self.pc, vocab=V, dim=D, max_retry=max_retry)

    def rows(self):
        return np.concatenate([sh.snapshot_rows() for sh in self.shards])

    def slots(self, spec):
        snaps = [sh.snapshot_slots() for sh in self.shards]
        out = TO.zero_slots(spec, V, D)
        for name in out:
            if all(name in s for s in snaps):
                out[name] = np.concatenate([s[name] for s in snaps])
        return out

    def close(self):
        for svc in self.svcs:
            unregister_psserve(svc)
        for srv in self.servers:
            srv.stop()
            srv.join()
        self.pc.close()


@pytest.fixture(scope="module")
def fleets():
    made = {}

    def get(p):
        if p not in made:
            made[p] = _Fleet(p, _int_table(), f"f{p}")
        return made[p]

    yield get
    for f in made.values():
        f.close()
    HC.reset_all()


# ---- OptimizerSpec ----

def test_optimizer_spec_validation_and_wire_round_trips():
    with pytest.raises(ValueError):
        OptimizerSpec("rmsprop")
    with pytest.raises(ValueError):
        OptimizerSpec("sgdm", lr=float("nan"))
    with pytest.raises(ValueError):
        OptimizerSpec.from_wire({"kind": "sgdm", "lr": "fast"})
    for kind, kw in (("sgdm", dict(lr=0.25, momentum=0.75)),
                     ("adam", dict(lr=0.01, beta1=0.8, beta2=0.99,
                                   eps=1e-6))):
        spec = OptimizerSpec(kind, **kw)
        rspec = RO.OptimizerSpec(kind, **kw)
        assert spec.to_wire() == rspec.to_wire()
        assert spec.to_frame_fields() == rspec.to_frame_fields()
        assert spec.slot_names() == rspec.slot_names()
        assert OptimizerSpec.from_wire(rspec.to_wire()) == spec
        assert OptimizerSpec.from_frame_fields(
            rspec.to_frame_fields()) == spec
    assert OptimizerSpec.from_frame_fields({"keys": None}) is None
    with pytest.raises(ValueError):
        TO.fused_apply("rmsprop")


# ---- fused_apply / oracle_apply against the reference ----

@pytest.mark.parametrize("data", ["int", "random"])
@pytest.mark.parametrize("kind", ["sgdm", "adam"])
def test_oracle_apply_matches_reference(kind, data):
    """Four chained waves with duplicate keys through both packages'
    dense oracles."""
    rng = np.random.default_rng(5)
    if data == "int":
        kw = SPECS[kind]
        table = _int_table()
    else:
        kw = dict(lr=0.01)
        table = init_embedding_table(V, D, seed=3)
    spec, rspec = OptimizerSpec(kind, **kw), RO.OptimizerSpec(kind, **kw)
    tt, ts = table, TO.zero_slots(spec, V, D)
    rt, rs = table, RO.zero_slots(rspec, V, D)
    for _ in range(4):
        keys = rng.integers(0, V, size=9)
        grads = _int_grads(rng, 9) if data == "int" else \
            rng.standard_normal((9, D)).astype(np.float32)
        tt, ts = oracle_apply(tt, ts, keys, grads, spec, device=CPU)
        rt, rs = RO.oracle_apply(rt, rs, keys, grads, rspec)
    assert not np.array_equal(tt, table)
    if data == "int":
        np.testing.assert_array_equal(tt, rt)
        for name in rs:
            np.testing.assert_array_equal(ts[name], rs[name],
                                          err_msg=name)
    else:
        _close(tt, rt, 1e-6)
        for name in rs:
            _close(ts[name], rs[name], 1e-6)
    assert table is not tt      # inputs untouched
    np.testing.assert_array_equal(table, _int_table() if data == "int"
                                  else init_embedding_table(V, D, seed=3))


@pytest.mark.parametrize("kind", ["sgdm", "adam"])
def test_fused_apply_in_place_with_padding(kind):
    """The in-place fused program on padded keys equals the reference's
    jitted one: pad entries (valid 0) add nothing and do not touch row
    0, duplicates step once."""
    spec = OptimizerSpec(kind, **SPECS[kind])
    rng = np.random.default_rng(9)
    table = _int_table()
    n, b = 6, 8
    keys = np.zeros((b,), np.int64)
    keys[:n] = [3, 7, 3, 40, 7, 3]
    grads = np.zeros((b, D), np.float32)
    grads[:n] = _int_grads(rng, n)
    valid = np.zeros((b,), np.float32)
    valid[:n] = 1.0
    names = spec.slot_names()
    slots = TO.zero_slots(spec, V, D)
    state = [torch.tensor(table)] + [torch.tensor(slots[k]) for k in names]
    ptrs = [t.data_ptr() for t in state]
    hp = [spec.lr, spec.momentum] if kind == "sgdm" else \
        [spec.lr, spec.beta1, spec.beta2, spec.eps]
    out = TO.fused_apply(kind)(*state, torch.from_numpy(keys),
                               torch.from_numpy(grads),
                               torch.from_numpy(valid), *hp)
    assert [t.data_ptr() for t in out] == ptrs      # in place
    want = RO.fused_apply(kind)(
        jnp.asarray(table), *[jnp.asarray(slots[k]) for k in names],
        keys, grads, valid, *hp)
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    np.testing.assert_array_equal(out[0][0].numpy(), table[0])
    assert float(out[1][0].abs().sum()) == 0.0       # row 0's m


# ---- the fused optimizer through PS.Update ----

@pytest.mark.parametrize("kind", ["sgdm", "adam"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_fused_optimizer_bit_identity_rpc(kind, p, fleets):
    """sgdm/adam through PS.Update against {1,2,4} partitions land
    bit-identical rows AND slots to the dense oracle."""
    f = fleets(p)
    spec = OptimizerSpec(kind, **SPECS[kind])
    cli = f.client()
    rng = np.random.default_rng(17 + p)
    want_t, want_s = f.rows(), f.slots(spec)
    for _ in range(4):
        keys = rng.integers(0, V, size=9).astype(np.int64)
        grads = _int_grads(rng, 9)
        cli.update(keys, grads, optimizer=spec)
        want_t, want_s = oracle_apply(want_t, want_s, keys, grads, spec,
                                      device=CPU)
    np.testing.assert_array_equal(f.rows(), want_t)
    got_s = f.slots(spec)
    for name in spec.slot_names():
        np.testing.assert_array_equal(got_s[name], want_s[name],
                                      err_msg=f"slot {name!r}")


def test_retried_wave_steps_momentum_exactly_once(fleets):
    """An ack dropped AFTER the fused apply surfaces as a failed wave
    carrying its update_token; the replay dedups: version AND momentum
    advance exactly once."""
    f = fleets(2)
    spec = OptimizerSpec("sgdm", **SPECS["sgdm"])
    cli = f.client(max_retry=0)
    rng = np.random.default_rng(7)
    keys = rng.integers(0, V, size=8).astype(np.int64)
    grads = _int_grads(rng, 8)
    want_t, want_s = oracle_apply(f.rows(), f.slots(spec), keys, grads,
                                  spec, device=CPU)
    vers = [sh.version for sh in f.shards]
    dups = sum(sh.n_dup_updates for sh in f.shards)
    plan = fault.FaultPlan(0).on(
        fault.PS_OPT_APPLY, fault.ERROR, times=1,
        match=lambda ctx: ctx.get("stage") == "post")
    with fault.injected(plan):
        tok = None
        for _ in range(4):
            try:
                cli.update(keys, grads, update_token=tok, optimizer=spec)
                break
            except errors.RpcError as e:
                tok = e.update_token
        else:
            pytest.fail("wave never healed")
    assert plan.injected[fault.PS_OPT_APPLY] == 1
    np.testing.assert_array_equal(f.rows(), want_t)
    np.testing.assert_array_equal(f.slots(spec)["m"], want_s["m"])
    assert [sh.version - v for sh, v in zip(f.shards, vers)] == [1, 1]
    assert sum(sh.n_dup_updates for sh in f.shards) > dups


# ---- the trainer's loss and gradients against the reference's ----

def test_trainer_loss_and_grads_match_reference():
    rcfg = _cfg(RPSConfig)
    ref = RTrainer(types.SimpleNamespace(vocab=V, dim=D), rcfg)
    rng = np.random.default_rng(3)
    rows = (rng.standard_normal((rcfg.batch, rcfg.seq, D)) * 0.3
            ).astype(np.float32)
    dense = {"w_qk": rng.standard_normal((2, D, D)),
             "w_up": rng.standard_normal((2, D, 2 * D)),
             "w_down": rng.standard_normal((2, 2 * D, D)),
             "w_out": rng.standard_normal((D, V))}
    dense = {k: (v * 0.3).astype(np.float32) for k, v in dense.items()}
    targets = rng.integers(0, V, (rcfg.batch, rcfg.seq))
    jl, (jg_rows, jg_dense) = ref._grad_fn(
        jnp.asarray(rows), {k: jnp.asarray(v) for k, v in dense.items()},
        jnp.asarray(targets, jnp.int32))
    tl, (tg_rows, tg_dense) = loss_and_grads_from_rows(
        torch.from_numpy(rows),
        {k: torch.from_numpy(v) for k, v in dense.items()},
        torch.from_numpy(targets))
    assert abs(float(tl) - float(jl)) <= 2.0 ** -8 * abs(float(jl))
    assert tg_rows.dtype == torch.float32
    _close(tg_rows.numpy(), np.asarray(jg_rows), 2.0 ** -6)
    for k in dense:
        assert tg_dense[k].dtype == torch.float32
        _close(tg_dense[k].numpy(), np.asarray(jg_dense[k]), 2.0 ** -6)


def test_trainer_needs_a_card_unless_told_and_refuses_arbiter(
        monkeypatch):
    """The arbiter refusal this name records is gone: the trainer takes
    ``arbiter=`` (its waves pass ``admit_wave``, ``test_torch_arbiter``
    drives them) and the package exports the arbiter's classes.  Without
    a card and without ``device="cpu"`` it still raises."""
    from brpc_tpu_torch.train import arbiter
    cli = types.SimpleNamespace(vocab=V, dim=D)
    arb = arbiter.TrafficArbiter(name="ttrain_arb")
    tr = DataParallelTrainer(cli, _cfg(), arbiter=arb, device=CPU)
    assert tr.arbiter is arb and tr.stats()["paced_waves"] == 0
    assert train.TrafficArbiter is arbiter.TrafficArbiter
    assert train.MixedWorkloadHarness is arbiter.MixedWorkloadHarness
    assert train.DataParallelTrainer is DataParallelTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelTrainer(cli, _cfg())


# ---- DataParallelTrainer through the wire ----

def _trainer_fleet(tag, seed=0, **tr_kw):
    embed0, dense0 = DataParallelTrainer.model_init(_cfg(), seed=seed)
    f = _Fleet(2, embed0, tag)
    tr = DataParallelTrainer(f.client(), _cfg(), seed=seed, device=CPU,
                             **tr_kw)
    tr.seed_dense(dense0)
    return tr, f


@pytest.mark.parametrize("mode", ["wire", "pull_compute_push"])
def test_trainer_loss_decreases_through_service(mode):
    tr, f = _trainer_fleet(f"loss_{mode}", n_workers=2, steps=5,
                           mode=mode,
                           optimizer=OptimizerSpec("sgdm", lr=0.5,
                                                   momentum=0.5))
    try:
        rep = tr.run()
        assert rep["loss_final"] < rep["loss_first"], rep
        assert rep["steps_done"] == 10 and rep["waves"] == 10
        assert rep["stale_reads"] == 0
        for sh in f.shards:
            assert sh.version == sh.n_updates + sh.n_pushes
            # the fused path keeps momentum on the shard; the baseline
            # keeps it at the trainer
            assert bool(sh.snapshot_slots()) == (mode == "wire")
    finally:
        f.close()


def test_trainer_wave_faults_heal_exactly_once():
    """Injected update-wave failures force token replays; every shard
    still advances once per DISTINCT wave and training completes."""
    tr, f = _trainer_fleet("heal", n_workers=2, steps=4,
                           wave_max_retry=4, retry_backoff_s=0.01)
    plan = fault.FaultPlan(1).on(fault.UPDATE_WAVE, fault.ERROR, times=3)
    try:
        with fault.injected(plan):
            rep = tr.run()
        assert plan.injected[fault.UPDATE_WAVE] == 3
        assert rep["wave_retries"] >= 3
        assert rep["waves"] == 8
        assert rep["stale_reads"] == 0
        for sh in f.shards:
            assert sh.version == sh.n_updates + sh.n_pushes
    finally:
        f.close()


def test_trainer_gate_excuses_dead_worker():
    """max_lag=0 is a per-step barrier; a worker that dies mid-run is
    excused so the remaining workers drain instead of wedging."""
    tr, f = _trainer_fleet("gate", n_workers=2, steps=3, sync=True)
    plan = fault.FaultPlan(0).on(
        fault.UPDATE_WAVE, fault.ERROR, times=-1, after=1,
        match=lambda ctx: ctx.get("worker") == 1)
    tr.wave_max_retry = 0
    tr.retry_backoff_s = 0.0
    try:
        with fault.injected(plan):
            with pytest.raises(errors.RpcError):
                tr.run()
        assert tr._progress[0] == 3
        assert tr.stats()["progress"][1] == 3      # excused
    finally:
        f.close()


def test_embedding_server_example_trains_on_cpu(capsys):
    from brpc_tpu_torch.examples import embedding_server
    assert embedding_server.main(["--device", "cpu", "--shards", "2",
                                  "--steps", "3"]) == 0
    assert "OK: the loss fell" in capsys.readouterr().out
