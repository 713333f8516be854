"""The port's DynamicBatcher held against the JAX package's.

Counterparts, with the same asserts and no wall-clock asserts, of the
batcher tests in ``tests/test_serving.py`` (scatter, bucket shapes,
rejects, deadline shed locally and over RPC, coalescing, limiter,
raising callbacks, ``padded_output``, close unpinning its bvars), the
eager-mode tests of ``tests/test_tensorframe.py`` (cut-through and
coalescing, the idle claim, the window-free deadline shed, no overlap at
close), the prefix-trim, offsets and EDF tests of
``tests/test_kvcache.py`` on a port store, and
``test_model_runner.py``'s score test (a port runner over the JAX
package's parameters against the JAX package's ``dense_forward``).
Plus: ``stats()`` has the reference's keys, the concurrency limiters
decide as the reference's on seeded sequences, and the ``serving.batch``
fault site fails a whole batch definitively.  Ordering comes from gates
and counters, never from sleeps.
"""
import gc
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brpc_tpu.policy.concurrency_limiter as ref_cl
from brpc_tpu.models import runner as R
from brpc_tpu.serving.batcher import DynamicBatcher as RefBatcher
import brpc_tpu_torch.policy.concurrency_limiter as cl
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors, fault, serving
from brpc_tpu_torch.bvar import exposed_variables
from brpc_tpu_torch.kvcache import KVCacheStore
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.serving import DynamicBatcher, register_serving

from testutil import wait_until
from test_torch_runner import JCFG, JPARAMS, TCFG, _tparams

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    """A client whose server this module stops marks that endpoint for
    the port's health check: retire the probes when the module ends."""
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


def _sum_fn():
    """Per-row sum recording each call's (padded) shape."""
    shapes = []

    def fn(x):
        shapes.append(tuple(x.shape))
        return np.asarray(x).sum(axis=1)

    return fn, shapes


@pytest.fixture(autouse=True)
def _no_fault_plan():
    fault.clear()
    yield
    fault.clear()


# ---- batcher core (tests/test_serving.py) ----

def test_batcher_scatter_correctness():
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=4, max_delay_us=2000,
                       length_buckets=(16, 64), name="tt_scatter")
    try:
        results = {}

        def one(i, ln):
            results[i] = float(b.submit_wait(np.full((ln,), i + 1.0,
                                                     np.float32)))

        ts = [threading.Thread(target=one, args=(i, ln))
              for i, ln in enumerate((3, 7, 20, 1, 40))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(15)
        assert results == {0: 3.0, 1: 14.0, 2: 60.0, 3: 4.0, 4: 200.0}
    finally:
        b.close()


def test_batcher_pads_to_bucket_shapes_only():
    """Many raw lengths, few shapes: the batch function only ever sees
    bucket shapes."""
    fn, shapes = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=4, max_delay_us=500,
                       batch_buckets=(4,), length_buckets=(16, 64),
                       name="tt_buckets")
    try:
        for ln in range(1, 41):
            assert float(b.submit_wait(np.ones((ln,), np.float32))) == \
                pytest.approx(float(ln))
        assert set(shapes) == {(4, 16), (4, 64)}, shapes
        assert b.stats()["pad_waste_ratio"] > 0
    finally:
        b.close()


def test_batcher_rejects_oversized_and_bad_rank():
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), name="tt_reject")
    try:
        for item in (np.ones((17,), np.float32), np.ones((2, 2), np.float32)):
            with pytest.raises(errors.RpcError) as ei:
                b.submit_wait(item)
            assert ei.value.code == errors.EREQUEST
    finally:
        b.close()


def test_batcher_deadline_shed_local():
    """A deadline shorter than the batching window sheds with ELIMIT
    before any batch forms."""
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=16, max_delay_us=700_000,
                       length_buckets=(16,), name="tt_shed_local")
    try:
        with pytest.raises(errors.RpcError) as ei:
            b.submit_wait(np.ones((4,), np.float32),
                          deadline_s=time.monotonic() + 0.05)
        assert ei.value.code == errors.ELIMIT
        st = b.stats()
        assert st["shed"] == 1 and st["queued"] == 0 and st["batches"] == 0
    finally:
        b.close()


def test_batcher_coalesces_concurrent_requests():
    """The counterpart of the throughput test, on counters: while one
    batch executes, concurrent requests queue and leave in batches of
    more than one, every one completed, every queue delay recorded."""
    gate = threading.Event()
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        if len(calls) == 1:
            gate.wait(10)
        return np.asarray(x).sum(axis=1)

    b = DynamicBatcher(fn, max_batch_size=16, max_delay_us=20_000,
                       batch_buckets=(16,), length_buckets=(8,),
                       name="tt_coalesce")
    try:
        outs = []
        first = threading.Thread(
            target=lambda: outs.append(b.submit_wait(np.ones(8, np.float32))))
        first.start()
        assert wait_until(lambda: len(calls) == 1, 10)
        ts = [threading.Thread(target=lambda: outs.append(
            b.submit_wait(np.ones(8, np.float32)))) for _ in range(32)]
        for t in ts:
            t.start()
        assert wait_until(lambda: b.stats()["queued"] == 32, 10)
        gate.set()
        first.join(10)
        for t in ts:
            t.join(10)
        st = b.stats()
        assert len(outs) == 33 and all(float(o) == 8.0 for o in outs)
        assert st["completed"] == 33 and st["batches"] == 3
        assert calls == [16, 16, 16]      # 1 row, then 32 in two of 16
        assert st["avg_batch_size"] == 11.0
        assert b.queue_delay_rec.count() == 33
    finally:
        gate.set()
        b.close()


def test_batcher_limiter_integration():
    """The queue limiter takes the servers' create_limiter specs and
    answers ELIMIT like any admission refusal."""
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=4, max_delay_us=10_000_000,
                       length_buckets=(16,), limiter=2, name="tt_limiter")
    outcomes = []
    mu = threading.Lock()

    def fire(code, text, result):
        with mu:
            outcomes.append(code)

    try:
        for _ in range(5):
            b.enqueue(np.ones((4,), np.float32), fire)
        # the window is 10 s: the refusals are the admission's own
        assert outcomes == [errors.ELIMIT] * 3   # queue capped at 2
    finally:
        b.close()                                # flushes the two queued
    assert sorted(outcomes) == [0, 0] + [errors.ELIMIT] * 3


def test_batcher_survives_raising_completion_and_transform():
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=4, max_delay_us=1000,
                       length_buckets=(16,), name="tt_raising")
    try:
        b.enqueue(np.ones((4,), np.float32),
                  lambda code, text, result: 1 / 0)
        assert float(b.submit_wait(np.ones((3,), np.float32))) == 3.0
    finally:
        b.close()


def test_batcher_padded_output_flag_overrides_heuristic():
    def fixed16(x):                       # [B, 16] -> [B, 16] fixed width
        return np.tile(np.asarray(x).sum(axis=1, keepdims=True), (1, 16))

    b = DynamicBatcher(fixed16, max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), padded_output=False,
                       name="tt_fixedw")
    try:
        row = b.submit_wait(np.ones((3,), np.float32))
        assert row.shape == (16,)
        assert row == pytest.approx(np.full((16,), 3.0))
    finally:
        b.close()


def test_torch_outputs_scatter_like_numpy():
    """A batch function may return a torch tensor; rows come back as
    numpy."""
    b = DynamicBatcher(lambda x: torch.from_numpy(np.asarray(x)).sum(dim=1),
                       max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), name="tt_torch_out")
    try:
        out = b.submit_wait(np.ones((5,), np.float32))
        assert isinstance(out, np.generic) or isinstance(out, np.ndarray)
        assert float(out) == 5.0
    finally:
        b.close()


def test_close_unpins_bvars_and_registry_entry():
    """close() hides exactly the batcher's own bvars (a sibling whose
    name merely starts with it keeps its own) and drops it from the
    serving registry."""
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), name="tt_unpin")
    sib = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                         length_buckets=(16,), name="tt_unpin_e")
    assert exposed_variables("serving_tt_unpin_*")
    assert exposed_variables("serving_tt_unpin_e_*")
    b.close()
    assert exposed_variables("serving_tt_unpin_e_*")
    assert not [n for n in exposed_variables("serving_tt_unpin_*")
                if not n.startswith("serving_tt_unpin_e_")]
    sib.close()
    assert not exposed_variables("serving_tt_unpin_*")
    del b, sib
    gc.collect()
    assert "tt_unpin" not in serving._batchers
    assert "tt_unpin_e" not in serving._batchers


def test_batch_fault_site_fails_every_member_once():
    fn, _ = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=4, max_delay_us=10_000_000,
                       length_buckets=(16,), name="tt_fault")
    outcomes = []
    plan = fault.FaultPlan(1).on(fault.BATCH, fault.ERROR, times=1)
    try:
        with fault.injected(plan):
            for _ in range(4):      # a full batch forms at once
                b.enqueue(np.ones((2,), np.float32),
                          lambda c, t, r: outcomes.append((c, t)))
            assert wait_until(lambda: len(outcomes) == 4, 10)
        assert plan.injected == {fault.BATCH: 1}
        assert [c for c, _ in outcomes] == [errors.EINTERNAL] * 4
        assert "injected" in outcomes[0][1]
        # the drainer lives on: the next full batch is served
        for _ in range(4):
            b.enqueue(np.ones((2,), np.float32),
                      lambda c, t, r: outcomes.append((c, t)))
        assert wait_until(lambda: len(outcomes) == 8, 10)
        assert [c for c, _ in outcomes[4:]] == [0] * 4
    finally:
        b.close()


def test_rpc_deadline_shed_elimit():
    """Over the port's server: a Controller deadline shorter than the
    batch window is shed with ELIMIT before formation; a request that
    can make its deadline is served."""
    fn, _ = _sum_fn()
    batcher = DynamicBatcher(fn, max_batch_size=16, max_delay_us=700_000,
                             length_buckets=(16,), name="tt_rpc")
    srv = rpc.Server()
    register_serving(srv, batcher=batcher)
    srv.start("127.0.0.1", 0)
    try:
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("Serving", "Score", {"x": [1.0, 2.0]},
                         serializer="json",
                         cntl=rpc.Controller(timeout_ms=150))
        assert ei.value.code == errors.ELIMIT
        st = batcher.stats()
        assert st["shed"] == 1 and st["queued"] == 0 and st["batches"] == 0
        got = ch.call_sync("Serving", "Score", {"x": [1.0, 2.0, 3.0]},
                           serializer="json",
                           cntl=rpc.Controller(timeout_ms=5000))
        assert got["y"] == pytest.approx(6.0)
        st = batcher.stats()
        assert st["queued"] == 0 and st["completed"] == 1
    finally:
        srv.stop()
        srv.join()
        batcher.close()


# ---- eager mode (tests/test_tensorframe.py) ----

def _first_col(padded):
    return np.asarray(padded[:, :1], np.float32)


def test_eager_batcher_cuts_through_when_idle_and_coalesces_under_load():
    calls = []
    ev = threading.Event()

    def fn(padded):
        calls.append(padded.shape[0])
        ev.wait(10)          # hold the slot so concurrent items queue
        return _first_col(padded)

    b = DynamicBatcher(fn, max_batch_size=8, max_delay_us=500_000,
                       length_buckets=(4,), dtype=np.int64,
                       padded_output=False, eager=True, name="tt_eager")
    try:
        ev.set()
        # idle: inline on this thread (the 500 ms window never applies)
        b.submit_wait(np.arange(4, dtype=np.int64), timeout_s=5)
        assert calls == [1] and b.stats()["batches"] == 1
        ev.clear()
        results = []

        def one():
            results.append(b.submit_wait(np.arange(4, dtype=np.int64),
                                         timeout_s=10))

        first = threading.Thread(target=one)
        first.start()
        assert wait_until(lambda: len(calls) == 2, 10)  # holds the slot
        ts = [threading.Thread(target=one) for _ in range(6)]
        for t in ts:
            t.start()
        assert wait_until(lambda: b.stats()["queued"] == 6, 10)
        ev.set()
        first.join(10)
        for t in ts:
            t.join(10)
        assert len(results) == 7
        st = b.stats()
        # the queued 6 formed one batch (padded to the 8 bucket)
        assert calls == [1, 1, 8] and st["batches"] == 3
        assert st["avg_batch_size"] == round(8 / 3, 2)
        assert st["eager"] is True
    finally:
        ev.set()
        b.close()


def test_idle_claim_bypass_still_coalesces_concurrent_arrivals():
    """The idle claim (a caller serving one request outside the batcher)
    holds the execution slot: arrivals meanwhile queue and coalesce into
    one batch once it is released; a brownout or a busy batcher refuses
    the claim."""
    calls = []
    b = DynamicBatcher(lambda p: calls.append(p.shape[0]) or _first_col(p),
                       max_batch_size=8, max_delay_us=500_000,
                       length_buckets=(4,), dtype=np.int64,
                       padded_output=False, eager=True, name="tt_claim")
    try:
        assert b.try_claim_idle()
        assert not b.try_claim_idle()             # one slot
        outs = []
        ts = [threading.Thread(target=lambda: outs.append(b.submit_wait(
            np.arange(4, dtype=np.int64), timeout_s=10))) for _ in range(5)]
        for t in ts:
            t.start()
        assert wait_until(lambda: b.stats()["queued"] == 5, 10)
        assert calls == []
        b.release_idle()
        for t in ts:
            t.join(10)
        st = b.stats()
        # one batch of the 5 (padded to the 8 bucket)
        assert len(outs) == 5 and calls == [8] and st["batches"] == 1
        assert st["avg_batch_size"] == 5.0 and st["bypassed"] == 1
        b.brownout = 1
        assert not b.try_claim_idle()
    finally:
        b.close()


def test_eager_deadline_shed_does_not_charge_the_window():
    kw = dict(max_batch_size=8, max_delay_us=500_000, length_buckets=(4,),
              dtype=np.int64, padded_output=False)
    be = DynamicBatcher(_first_col, eager=True, name="tt_shed_eager", **kw)
    bw = DynamicBatcher(_first_col, eager=False, name="tt_shed_windowed",
                        **kw)
    try:
        out = be.submit_wait(np.arange(4, dtype=np.int64),
                             deadline_s=time.monotonic() + 0.1, timeout_s=5)
        assert out is not None
        with pytest.raises(errors.RpcError) as ei:
            bw.submit_wait(np.arange(4, dtype=np.int64),
                           deadline_s=time.monotonic() + 0.1, timeout_s=5)
        assert ei.value.code == errors.ELIMIT
    finally:
        be.close()
        bw.close()


def test_eager_close_never_overlaps_inline_and_drainer_batches():
    mu = threading.Lock()
    active = [0]
    max_active = [0]
    gate = threading.Event()
    entered = threading.Event()

    def fn(padded):
        with mu:
            active[0] += 1
            max_active[0] = max(max_active[0], active[0])
        entered.set()
        gate.wait(10)
        with mu:
            active[0] -= 1
        return _first_col(padded)

    b = DynamicBatcher(fn, max_batch_size=8, max_delay_us=100,
                       length_buckets=(4,), dtype=np.int64,
                       padded_output=False, eager=True,
                       name="tt_eager_close")
    outcomes = []

    def one():
        try:
            outcomes.append(("ok", b.submit_wait(
                np.arange(4, dtype=np.int64), timeout_s=10)))
        except Exception as e:
            outcomes.append(("err", e))

    t1 = threading.Thread(target=one)       # inline, holds the slot
    t1.start()
    assert entered.wait(10)
    t2 = threading.Thread(target=one)       # queues behind it
    t2.start()
    assert wait_until(lambda: b.stats()["queued"] == 1, 10)
    closer = threading.Thread(target=b.close)   # flush DURING the inline
    closer.start()
    assert wait_until(lambda: not b._running, 10)
    gate.set()
    for t in (t1, t2, closer):
        t.join(10)
    assert len(outcomes) == 2
    assert max_active[0] == 1, \
        f"batches overlapped at shutdown (max concurrent={max_active[0]})"


# ---- prefix trim, offsets, EDF lanes (tests/test_kvcache.py) ----

def _mk_store(name, page_tokens=16, page_bytes=256):
    return KVCacheStore(device=CPU, page_bytes=page_bytes,
                        page_tokens=page_tokens, max_blocks=8, name=name)


def _warm(st, tokens):
    """Admit `tokens`, write (zero) K/V for all of them and retire: the
    port's store caches only materialised pages."""
    s = st.admit(tokens)
    st.write_kv(s, 0, torch.zeros((len(tokens),
                                   st.pagepool.kv_bytes_per_token),
                                  dtype=torch.uint8))
    st.retire(s)


def test_batcher_prefix_probe_trims_to_suffix():
    st = _mk_store("tt_probe_store")
    fn, shapes = _sum_fn()
    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                       batch_buckets=(2,), length_buckets=(16, 64),
                       prefix_cache=st, dtype=np.int32, name="tt_probe")
    try:
        _warm(st, list(range(48)) + [1])          # 3 cached pages
        cold = np.arange(40, dtype=np.int32) + 1000
        assert int(b.submit_wait(cold)) == int(cold.sum())
        # 48 cached + 6 new: only the suffix computes, in the SMALL
        # bucket a 54-token item could never fit
        warm = np.asarray(list(range(48)) + [5] * 6, np.int32)
        assert int(b.submit_wait(warm)) == 30
        assert set(shapes) == {(2, 64), (2, 16)}
        assert b.stats()["prefix_skip_ratio"] > 0.4
        # no pin leaked: the tree alone holds its pages
        st.pagepool.assert_consistent()
        assert st.stats()["pages"]["pages_in_use"] == \
            st.stats()["radix_nodes"]
    finally:
        b.close()
        st.clear()
    assert st.pagepool.blocks_leased() == 0


def test_batcher_prefix_offsets_reach_batch_fn():
    st = _mk_store("tt_offs_store")
    seen = []

    def fn(x, offsets):
        seen.append(np.asarray(offsets).tolist())
        return np.asarray(x).sum(axis=1) + np.asarray(offsets)

    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), prefix_cache=st,
                       dtype=np.int32, name="tt_offs")
    try:
        _warm(st, list(range(32)) + [1])
        got = b.submit_wait(np.asarray(list(range(32)) + [5, 5, 5],
                                       np.int32))
        assert int(got) == 15 + 32          # suffix sum + its offset
        assert any(32 in row for row in seen), seen
    finally:
        b.close()
        st.clear()


def test_batcher_offsets_not_passed_into_optional_param():
    st = _mk_store("tt_noffs_store")

    def fn(x, temperature=1.0):
        assert temperature == 1.0, "offsets leaked into temperature"
        return np.asarray(x).sum(axis=1) * temperature

    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                       length_buckets=(16,), prefix_cache=st,
                       dtype=np.int32, name="tt_noffs")
    try:
        assert not b._fn_wants_offsets
        _warm(st, list(range(32)) + [1])
        got = b.submit_wait(np.asarray(list(range(32)) + [5, 5], np.int32))
        assert int(got) == 10               # suffix only, no offset
    finally:
        b.close()
        st.clear()


def test_batcher_priority_lanes_edf():
    """More queued than one batch holds: the FIFO head keeps one seat,
    the nearest deadline fills the rest, counted as a lane promotion."""
    gate = threading.Event()
    ncalls = [0]

    def fn(x):
        ncalls[0] += 1
        if ncalls[0] == 1:
            gate.wait(10)
        return np.asarray(x).sum(axis=1)

    b = DynamicBatcher(fn, max_batch_size=2, max_delay_us=1000,
                       length_buckets=(16,), name="tt_lanes")
    order = []
    mu = threading.Lock()

    def fire_for(tag):
        def fire(code, text, result):
            with mu:
                order.append(tag)
        return fire

    try:
        b.enqueue(np.ones((4,), np.float32), fire_for("w1"))
        b.enqueue(np.ones((4,), np.float32), fire_for("w2"))
        assert wait_until(lambda: ncalls[0] == 1, 10)
        now = time.monotonic()
        b.enqueue(np.ones((4,), np.float32), fire_for("no_deadline"))
        b.enqueue(np.ones((4,), np.float32), fire_for("late"),
                  deadline_s=now + 60)
        b.enqueue(np.ones((4,), np.float32), fire_for("urgent"),
                  deadline_s=now + 20)
        gate.set()
        assert wait_until(lambda: len(order) == 5, 15)
        assert set(order[2:4]) == {"no_deadline", "urgent"}
        assert order[4] == "late"
        assert b.stats()["lane_promotions"] == 1
    finally:
        gate.set()
        b.close()


# ---- scoring through a real runner (test_model_runner.py) ----

def test_batcher_scores_through_runner_dense_path():
    """A port TransformerRunner over the JAX package's parameters drops
    in as the batch function: each row's per-position greedy ids equal
    the JAX package's dense forward's argmax."""
    runner = T.TransformerRunner(_tparams(), TCFG, device=CPU,
                                 name="tt_score")
    b = DynamicBatcher(runner, max_batch_size=4, max_delay_us=500,
                       length_buckets=(8, 16), dtype=np.int32,
                       name="tt_score_b")
    try:
        prompt = np.array([5, 17, 42, 9], np.int32)
        got = b.submit_wait(prompt, timeout_s=120)
        logits = R.dense_forward(JPARAMS, JCFG, jnp.asarray(prompt[None]),
                                 jnp.arange(4, dtype=jnp.int32)[None])
        ref = np.asarray(jnp.argmax(logits, axis=-1))[0]
        np.testing.assert_array_equal(np.asarray(got, np.int64),
                                      ref.astype(np.int64))
    finally:
        b.close()


# ---- parity with the reference's bookkeeping ----

def test_stats_keys_equal_the_reference():
    fn, _ = _sum_fn()
    port = DynamicBatcher(fn, max_batch_size=2, max_delay_us=500,
                          length_buckets=(16,), name="tt_keys")
    ref = RefBatcher(fn, max_batch_size=2, max_delay_us=500,
                     length_buckets=(16,), name="tt_keys_ref")
    try:
        for b in (port, ref):
            assert float(b.submit_wait(np.ones((3,), np.float32))) == 3.0
        ps, rs = port.stats(), ref.stats()
        assert set(ps) == set(rs)
        for k in ("batches", "completed", "errors", "shed", "queued",
                  "batch_buckets", "length_buckets", "avg_batch_size",
                  "pad_waste_ratio", "prefix_skip_ratio"):
            assert ps[k] == rs[k], k
    finally:
        port.close()
        ref.close()


class _Clock:
    """A seeded monotonic clock for the limiters' windows."""

    def __init__(self, rng):
        self.t = 1000.0
        self.rng = rng

    def monotonic(self):
        self.t += float(self.rng.uniform(0.0, 0.05))
        return self.t


@pytest.mark.parametrize("spec", [2, "constant:3", "timeout", "timeout:5",
                                  "auto"])
def test_limiter_decisions_equal_the_reference(monkeypatch, spec):
    """The same seeded sequence of admissions and responses (latencies,
    error codes, and for "auto" a patched clock) through both packages'
    limiters: the same decision at every step, the same limit after."""
    limiters = []
    for mod, seed in ((cl, 7), (ref_cl, 7)):
        monkeypatch.setattr(mod, "time", _Clock(np.random.default_rng(seed)))
        limiters.append(mod.create_limiter(spec))
    port, ref = limiters
    assert type(port).__name__ == type(ref).__name__
    rng = np.random.default_rng(11)
    for _ in range(3000):
        if rng.random() < 0.5:
            c = int(rng.integers(0, 120))
            assert port.on_requested(c) == ref.on_requested(c), c
        else:
            code = 0 if rng.random() < 0.9 else errors.ELIMIT
            lat = int(rng.integers(100, 20_000))
            port.on_responded(code, lat)
            ref.on_responded(code, lat)
        assert port.max_concurrency() == ref.max_concurrency()
