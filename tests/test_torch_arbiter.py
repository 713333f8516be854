"""The port's TrafficArbiter and MixedWorkloadHarness held against the
JAX package's.

Counterparts of ``tests/test_train.py``'s three arbiter tests (a
synthetic pressure ramp fires pace_trainer -> shed_trainer -> brownout
-> clamp strictly in that order and calm ticks revert the serving
actions; shed holds waves until calm; a shed that outlasts its timeout
is ELIMIT) and ``test_mixed_harness_all_shapes_one_fleet`` (zipf
lookups, streamed generations and trainer waves on one fleet on the
CPU: exactly-once applies, no stale read, queues drained, pools at
their baseline, every generation bit-exact).  Then both packages'
arbiters over one seeded pressure sequence: the same level each tick,
the same fire counters and first-fired ticks, the same pace/shed
decisions.
"""
import threading
import time

import numpy as np
import pytest

from brpc_tpu_torch import errors
from brpc_tpu_torch.train.arbiter import (ARBITER_LEVEL_NAMES,
                                          MixedWorkloadHarness,
                                          TrafficArbiter)

CPU = "cpu"


class _FakeBatcher:
    brownout = 0


class _FakeEngine:
    degraded_clamp = None


def test_arbiter_ramp_fires_cheapest_first():
    """A pressure ramp walks the ladder pace_trainer -> shed_trainer ->
    brownout -> clamp; the first-fired ticks are strictly ordered, so
    the trainer rungs absorb overload before any serving component is
    touched."""
    b, e = _FakeBatcher(), _FakeEngine()
    arb = TrafficArbiter(batchers=[b], engines=[e], hysteresis_ticks=2,
                         pace_delay_s=0.0, shed_poll_s=0.005)
    assert arb.tick({"queue_delay_us": 0.0}) == 0
    assert arb.admit_wave() is False            # calm: free admission
    assert arb.tick({"queue_delay_us": 20_000.0}) == 1
    assert arb.admit_wave() is True             # paced, not refused
    assert b.brownout == 0 and e.degraded_clamp is None
    assert arb.tick({"queue_delay_us": 60_000.0}) == 2
    assert b.brownout == 0, "serving touched before the trainer shed"
    assert arb.tick({"queue_delay_us": 200_000.0}) == 3
    assert b.brownout >= 1 and e.degraded_clamp is None
    assert arb.tick({"queue_delay_us": 600_000.0}) == 4
    assert e.degraded_clamp is not None
    ff = arb.ladder.first_fired[1:]
    assert None not in ff and ff == sorted(ff) and len(set(ff)) == 4
    assert arb.ladder.level_names == ARBITER_LEVEL_NAMES
    for _ in range(20):         # calm ticks walk down and REVERT
        arb.tick({"queue_delay_us": 0.0})
    assert arb.ladder.level == 0
    assert b.brownout == 0 and e.degraded_clamp is None
    st = arb.stats()
    assert st["paced_waves"] == 1 and st["brownouts"] == 1 \
        and st["clamps"] == 1


def test_arbiter_shed_blocks_waves_until_calm():
    arb = TrafficArbiter(hysteresis_ticks=1, shed_poll_s=0.005,
                         pace_delay_s=0.0)
    arb.tick({"queue_delay_us": 60_000.0})
    assert arb.ladder.level == 2
    out = {}

    def wave():
        out["paced"] = arb.admit_wave()

    t = threading.Thread(target=wave, daemon=True)
    t.start()
    time.sleep(0.08)
    assert "paced" not in out, "a wave was admitted while shed"
    assert arb.stats()["shed_waves"] == 1
    while arb.ladder.level >= 2:        # the hysteretic walk down
        arb.tick({"queue_delay_us": 0.0})
    t.join(5)
    assert out.get("paced") is True
    assert arb.stats()["admitted_waves"] == 1


def test_arbiter_shed_timeout_surfaces_elimit():
    arb = TrafficArbiter(shed_poll_s=0.005, shed_timeout_s=0.05)
    arb.tick({"queue_delay_us": 60_000.0})
    with pytest.raises(errors.RpcError) as ei:
        arb.admit_wave()
    assert ei.value.code == errors.ELIMIT


def test_mixed_harness_all_shapes_one_fleet():
    """Zipf lookups, streamed generations and trainer waves on ONE
    fleet, arbitrated: every invariant holds."""
    h = MixedWorkloadHarness(n_shards=2, vocab=48, dim=8, n_replicas=1,
                             lookup_workers=1, gen_workers=1,
                             gen_tokens=8, train_workers=2, train_steps=3,
                             seed=0, name="tarb_mix", device=CPU)
    try:
        rep = h.run()
    finally:
        h.close()
    assert all(rep["exactly_once"]), rep["shards"]
    assert rep["stale_reads"] == 0
    assert rep["queues_drained"] and rep["pools_at_baseline"]
    gen = rep["shapes"]["generate"]
    assert gen["ok"] > 0 and gen["mismatch"] == 0
    assert gen["bit_exact"] == gen["ok"]
    assert rep["shapes"]["lookup"]["ok"] > 0
    assert rep["train"]["waves"] == 6
    assert rep["train"]["loss_final"] < rep["train"]["loss_first"]
    # every admitted wave passed the arbiter
    assert rep["arbiter"]["admitted_waves"] >= rep["train"]["waves"]


def test_arbiter_decisions_equal_reference_over_one_pressure_sequence():
    """Both packages' arbiters over the same seeded pressures: the same
    level every tick, the same serving actions, the same pace and shed
    decisions (read without blocking), and equal ladder stats."""
    from brpc_tpu.train.arbiter import TrafficArbiter as RefArbiter
    rng = np.random.default_rng(11)
    seq = []
    for i in range(300):
        p = {"queue_delay_us": float(rng.uniform(0, 700_000)),
             "queue_depth": float(rng.uniform(0, 160)),
             "pool_ratio": float(rng.uniform(0, 1.0))}
        if (i // 25) % 2:
            p = {k: v / 20 for k, v in p.items()}       # calm stretches
        seq.append(p)
    runs = {}
    for name, cls in (("jax", RefArbiter), ("port", TrafficArbiter)):
        b, e = _FakeBatcher(), _FakeEngine()
        floor = [0]
        arb = cls(batchers=[b], engines=[e], hysteresis_ticks=3,
                  cluster_floor_sources=[lambda: floor[0]])
        trace = []
        for i, p in enumerate(seq):
            floor[0] = 1 if 100 <= i < 110 else 0
            trace.append((arb.tick(p), b.brownout, e.degraded_clamp,
                          arb.effective_level(), arb.cluster_floor()))
        st = arb.stats()
        st.pop("name")
        runs[name] = (trace, st)
    assert runs["port"] == runs["jax"]
