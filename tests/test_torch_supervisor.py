"""The port's EngineSupervisor, engine hooks and overload ladder, held
against the JAX package.

Counterparts of ``tests/test_supervisor.py``'s crash, wedge, give-up,
flapping-quarantine, ladder, brownout and claim-retry tests, on a port
engine over a port
runner at ``TransformerConfig()`` (parameters from the JAX package by
``params_from_jax``), on the CPU.  Every expected stream is the JAX
package's greedy decode: its ``dense_forward``, teacher-forced over
prompt + stream in one batched call, must pick every streamed token.
Crashes come from the port's ``fault.FaultPlan`` at the sites the port
carries (named by ``fault.STEP`` and its siblings), scheduled by hit
count (``after``/``times``), and the asserts
read counters and error codes, never wall-clock rates.  Plus: a crashed
speculative verify handed over and resumed exactly once, and the
``OverloadLadder`` against the reference's over a seeded pressure
sequence.  ("Raw block mode" has no counterpart: the port has no
step-function adapter.)
"""
import functools
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from brpc_tpu.serving.ladder import OverloadLadder as RefLadder
from brpc_tpu_torch import errors, fault
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.policy.circuit_breaker import global_breaker
from brpc_tpu_torch.policy.load_balancer import PrefixAffinityLB, ServerNode
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.serving import (DecodeEngine, DynamicBatcher,
                                    EngineSupervisor, NGramProposer)
from brpc_tpu_torch.serving.ladder import (OverloadLadder,
                                           apply_level_to_components)

from test_torch_runner import (JCFG, JPARAMS, TCFG, _tparams,
                               jax_dense_forward)
from testutil import wait_until

CPU = "cpu"
PARAMS = _tparams()
# ladder thresholds no test burst can cross: the crash tests isolate
# recovery from the (separately tested) ladder
CALM_LADDER = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
                "queue_depth": 1e9},) * 3
# every checked stream: a 9-token prompt and 6 new tokens, so the JAX
# check is one compiled [GREEDY_ROWS, 14] forward for the whole file
PROMPT_LEN, NEW = 9, 6
GREEDY_ROWS = 6


@pytest.fixture(autouse=True)
def _no_fault_plan():
    fault.clear()
    yield
    fault.clear()


@functools.cache
def _jax_greedy(seqs: tuple) -> list:
    logits = jax_dense_forward(
        JPARAMS, JCFG, jnp.asarray(seqs, jnp.int32),
        jnp.tile(jnp.arange(len(seqs[0]), dtype=jnp.int32)[None],
                 (len(seqs), 1)))
    return np.asarray(jnp.argmax(logits, axis=-1)).tolist()


def assert_jax_greedy(prompts, streams):
    """Teacher-forced over prompt + stream[:-1], the JAX package picks
    every streamed token (rows padded to one compiled shape)."""
    seqs = [tuple(p) + tuple(s[:-1]) for p, s in zip(prompts, streams)]
    assert all(len(q) == PROMPT_LEN + NEW - 1 for q in seqs)
    for k in range(0, len(seqs), GREEDY_ROWS):
        chunk = seqs[k:k + GREEDY_ROWS]
        pad = chunk + [chunk[0]] * (GREEDY_ROWS - len(chunk))
        pred = _jax_greedy(tuple(pad))
        for row, p, s in zip(pred, prompts[k:], streams[k:k + GREEDY_ROWS]):
            assert row[len(p) - 1:] == list(s)


def _prompts(n, base=0):
    return [[20, 21, 22, 23, 24, 25, 26, 27, (base + 100 + i) % TCFG.vocab]
            for i in range(n)]


class _SlowRunner(T.TransformerRunner):
    """The port runner with a slow step: decode outlives a short
    watchdog deadline."""
    delay_s = 0.08

    def step(self, *a, **kw):
        time.sleep(self.delay_s)
        return super().step(*a, **kw)


def _factory(store, name, *, runner_cls=T.TransformerRunner, slots=3,
             **kw):
    def make():
        runner = runner_cls(PARAMS, TCFG, store=store, device=CPU)
        return DecodeEngine(runner=runner, store=store, num_slots=slots,
                            max_pages_per_slot=24, prefill_buckets=(8, 16),
                            device=CPU, name=name, **kw)
    return make


def _store(name, max_blocks=32):
    return T.make_store_for(TCFG, page_tokens=4, max_blocks=max_blocks,
                            device=CPU, name=name)


def _submit_wave(sup, prompts, max_new):
    sinks = []
    for p in prompts:
        ev, toks, errs = threading.Event(), [], []
        sinks.append((ev, toks, errs))
        sup.submit(p, max_new, toks.append,
                   lambda e, ev=ev, errs=errs: (errs.append(e), ev.set()))
    return sinks


def _close(sup, store):
    sup.close()
    store.clear()
    assert store.stats()["live_seqs"] == 0
    assert store.pagepool.blocks_leased() == 0, "pool not at its baseline"


def _warm(sup):
    done = threading.Event()
    sup.submit([1, 2, 3, 4, 5], 2, lambda t: None, lambda e: done.set())
    assert done.wait(30)


class TestCrashRecovery:
    @pytest.mark.parametrize("site,draft", [
        (fault.STEP, None), (fault.SPEC_VERIFY, "ngram")])
    def test_crash_mid_decode_recovers_bit_exact(self, site, draft):
        """One crash mid-decode (a plain step, or a speculative verify
        whose draft leases are released first): the engine is rebuilt
        on the same store, every stream is the JAX package's greedy
        decode exactly once, the re-admissions hit the detached
        prefix, and the pool ends at its baseline."""
        store = _store(f"tsup_cr_{site}")
        kw = {} if draft is None else {"draft_runner": NGramProposer(),
                                       "draft_len": 3}
        sup = EngineSupervisor(
            _factory(store, f"tsup_cr_eng_{site}", **kw), store=store,
            heartbeat_deadline_s=30.0, check_interval_s=0.02,
            ladder=CALM_LADDER, name=f"tsup_cr_{site}")
        try:
            _warm(sup)
            plan = fault.FaultPlan(11).on(site, fault.ERROR, times=1,
                                          after=2)
            prompts = _prompts(6)
            hit0 = store.hit_tokens
            with fault.injected(plan):
                sinks = _submit_wave(sup, prompts, NEW)
                for ev, _, _ in sinks:
                    assert ev.wait(60), "request hung across the restart"
            assert plan.injected == {site: 1}
            for ev, toks, errs in sinks:
                assert errs == [None], errs
            assert_jax_greedy(prompts, [t for _, t, _ in sinks])
            st = sup.stats()
            assert st["restarts"] == 1 and st["state"] == "healthy"
            assert st["last_recovery"]["stolen_slots"] >= 1
            assert st["last_recovery"]["pinned_seqs"] >= 1
            assert st["readmitted"] >= 1
            assert store.stats()["detached"] >= 1
            assert store.hit_tokens > hit0
            assert sup.join_idle(10)
        finally:
            _close(sup, store)

    def test_unsupervised_crash_fails_requests_with_einternal(self):
        """Without a crash handler a failed step still fails its
        requests definitively, as before supervision existed."""
        store = _store("tsup_unsup")
        eng = _factory(store, "tsup_unsup_eng")()
        plan = fault.FaultPlan(1).on(fault.STEP, fault.ERROR, times=1)
        try:
            with fault.injected(plan):
                ev, errs = threading.Event(), []
                eng.submit([1, 2, 3], 4, lambda t: None,
                           lambda e: (errs.append(e), ev.set()))
                assert ev.wait(30)
            assert errs[0].code == errors.EINTERNAL
            assert eng.crashed is None and eng.join_idle(10)
        finally:
            eng.close()
            store.clear()
        assert store.pagepool.blocks_leased() == 0

    def test_wedge_detected_via_heartbeat_and_taken_over_live(self):
        """A loop that RUNS but reports no progress (serving.heartbeat
        suppressed) is taken over live: the old loop, still stepping,
        never leaks a token into the re-admitted stream."""
        store = _store("tsup_wg_kv")
        sup = EngineSupervisor(
            _factory(store, "tsup_wg_eng", runner_cls=_SlowRunner, slots=2),
            store=store, heartbeat_deadline_s=0.3, check_interval_s=0.05,
            ladder=CALM_LADDER, name="tsup_wg")
        try:
            # a cold first forward can outlast the heartbeat deadline on
            # its own: warm the engine before the wedge is injected
            _warm(sup)
            plan = fault.FaultPlan(5).on(fault.HEARTBEAT, fault.ERROR,
                                         times=-1)
            prompt = _prompts(1, base=7)[0]
            toks, ev, errbox = [], threading.Event(), []
            with fault.injected(plan):
                sup.submit(prompt, NEW, toks.append,
                           lambda e: (errbox.append(e), ev.set()))
                assert ev.wait(60), "request hung under simulated wedge"
            assert errbox == [None]
            assert_jax_greedy([prompt], [toks])       # exactly once each
            st = sup.stats()
            assert st["restarts"] >= 1
            assert "wedged" in st["last_recovery"]["reason"]
        finally:
            _close(sup, store)

    def test_gives_up_after_max_restarts_with_definite_errors(self):
        """A permanently broken engine fails fast: past the restart
        budget the supervisor stops rebuilding, every pending request
        gets a definite error, and a new submission is refused too."""
        store = _store("tsup_gu_kv", max_blocks=16)
        sup = EngineSupervisor(
            _factory(store, "tsup_gu_eng", slots=2), store=store,
            heartbeat_deadline_s=30.0, check_interval_s=0.02,
            max_restarts=2, restart_window_s=600.0, ladder=CALM_LADDER,
            name="tsup_gu")
        try:
            _warm(sup)
            plan = fault.FaultPlan(9).on(fault.STEP, fault.ERROR,
                                         times=-1)   # crash EVERY step
            ev, errbox = threading.Event(), []
            with fault.injected(plan):
                sup.submit([9, 9, 9, 9], 8, lambda t: None,
                           lambda e: (errbox.append(e), ev.set()))
                assert ev.wait(60), "request hung after the supervisor gave up"
            assert errbox and errbox[0] is not None
            assert errbox[0].code in (errors.EINTERNAL, errors.ELOGOFF)
            st = sup.stats()
            assert st["state"] == "failed" and st["restarts"] == 3
            ev2, errs2 = threading.Event(), []
            sup.submit([1], 1, lambda t: None,
                       lambda e: (errs2.append(e), ev2.set()))
            assert ev2.wait(10)
            assert errs2[0] is not None
        finally:
            _close(sup, store)

    def test_endpoint_quarantine_is_refused(self):
        """Below ``quarantine_after`` crashes the endpoint is refused
        quarantine: one crash adds one to the breaker's isolation count,
        and the endpoint stays selectable."""
        victim = str2endpoint("127.0.0.1:41010")
        breaker = global_breaker()
        iso0 = breaker.isolation_count(victim)
        store = _store("tsup_qr_once")
        sup = EngineSupervisor(
            _factory(store, "tsup_qr_once_eng"), store=store,
            heartbeat_deadline_s=30.0, check_interval_s=0.02,
            quarantine_after=3, endpoint=victim, ladder=CALM_LADDER,
            name="tsup_qr_once")
        try:
            _warm(sup)
            plan = fault.FaultPlan(12).on(fault.STEP, fault.ERROR, times=1)
            with fault.injected(plan):
                sinks = _submit_wave(sup, _prompts(1), NEW)
                assert sinks[0][0].wait(60)
            assert sinks[0][2] == [None]
            st = sup.stats()
            assert st["restarts"] == 1
            assert breaker.isolation_count(victim) == iso0 + 1
            assert not HC.is_broken(victim)
            assert st["quarantined"] is False
            assert st["endpoint"] == "127.0.0.1:41010"
        finally:
            _close(sup, store)
            with breaker._mu:
                breaker._isolation_count.pop(victim, None)


    def test_concurrent_submitters_across_a_crash_exactly_once(self):
        """More submitter threads than cores and a short switch interval
        across a step crash: every request ends exactly once with no
        error, every stream equals the port's dense oracle (held against
        the JAX package by test_torch_runner.py), and the pool ends at
        its baseline."""
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        store = _store("tsup_stress")
        sup = EngineSupervisor(
            _factory(store, "tsup_stress_eng"), store=store,
            heartbeat_deadline_s=30.0, check_interval_s=0.01,
            ladder=CALM_LADDER, name="tsup_stress")
        prompts = [[(7 * i + j) % TCFG.vocab for j in range(3 + i % 5)]
                   for i in range(24)]
        plan = fault.FaultPlan(4).on(fault.STEP, fault.ERROR, times=1,
                                     after=5)
        done = [[] for _ in prompts]
        toks = [[] for _ in prompts]
        try:
            def submit(k):
                for i in range(k, len(prompts), 12):
                    sup.submit(prompts[i], 4, toks[i].append,
                               lambda e, i=i: done[i].append(e))

            with fault.injected(plan):
                ts = [threading.Thread(target=submit, args=(k,))
                      for k in range(12)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(30)
                assert not any(t.is_alive() for t in ts)
                assert sup.join_idle(60)
            assert plan.injected == {fault.STEP: 1}
            assert sup.stats()["restarts"] == 1
            assert all(d == [None] for d in done), done
            for p, got in zip(prompts, toks):
                assert got == T.dense_generate(PARAMS, TCFG, p, 4,
                                               device=CPU)
        finally:
            sys.setswitchinterval(old)
            _close(sup, store)


class TestFlappingQuarantine:
    def test_repeated_crashes_quarantine_endpoint_and_remap_share(
            self, monkeypatch):
        """Crashes feed the port's circuit breaker; past
        ``quarantine_after`` the replica's endpoint is marked broken, and
        prefix_affinity remaps ONLY the quarantined replica's share of
        prefixes.  The stream across the three crashes is the JAX
        package's greedy decode."""
        monkeypatch.setattr(HC, "health_check_interval_s", 0.02)
        eps = [str2endpoint(f"127.0.0.1:{41000 + i}") for i in range(3)]
        victim = eps[0]
        lb = PrefixAffinityLB()
        lb.reset_servers([ServerNode(ep) for ep in eps])
        rng = np.random.default_rng(5)
        prefixes = [rng.integers(0, TCFG.vocab, 4).tolist()
                    for _ in range(60)]
        before = {tuple(p): lb.select_for_prompt(p) for p in prefixes}
        assert set(before.values()) == set(eps), "ring did not spread"
        store = _store("tsup_qr")
        sup = EngineSupervisor(
            _factory(store, "tsup_qr_eng"), store=store,
            heartbeat_deadline_s=30.0, check_interval_s=0.02,
            max_restarts=6, quarantine_after=3, endpoint=victim,
            ladder=CALM_LADDER, name="tsup_qr")
        breaker = global_breaker()
        try:
            _warm(sup)
            iso0 = breaker.isolation_count(victim)
            # three crashes: one per engine incarnation
            plan = fault.FaultPlan(17).on(fault.STEP, fault.ERROR, times=3)
            prompts = _prompts(1, base=30)
            with fault.injected(plan):
                sinks = _submit_wave(sup, prompts, NEW)
                assert sinks[0][0].wait(60)
            assert sinks[0][2] == [None]
            assert_jax_greedy(prompts, [sinks[0][1]])
            st = sup.stats()
            assert st["restarts"] == 3
            assert breaker.isolation_count(victim) >= iso0 + 3
            assert HC.is_broken(victim)
            assert st["quarantined"] is True
            after = {tuple(p): lb.select_for_prompt(p) for p in prefixes}
            for key, ep in before.items():
                if ep != victim:
                    assert after[key] == ep, \
                        "healthy replica's prefix remapped"
                else:
                    assert after[key] != victim, \
                        "quarantined replica still selected"
        finally:
            _close(sup, store)
            HC.reset_all()
            with breaker._mu:
                breaker._isolation_count.pop(victim, None)
            assert wait_until(lambda: not HC.probe_threads(), timeout=5.0)


class TestDegradationLadder:
    def _mk(self):
        store = _store("tsup_lad_kv", max_blocks=16)
        batcher = DynamicBatcher(lambda x: np.asarray(x).sum(axis=1),
                                 max_batch_size=4, max_delay_us=500,
                                 length_buckets=(16,), name="tsup_lad_b")
        sup = EngineSupervisor(
            _factory(store, "tsup_lad_eng", slots=2), store=store,
            batcher=batcher, check_interval_s=10.0, clamp_new_tokens=7,
            hysteresis_ticks=2, name="tsup_lad")
        return store, batcher, sup

    def test_ladder_escalates_and_applies_actions(self, monkeypatch):
        store, batcher, sup = self._mk()
        try:
            ev0 = store.evictions
            pressure = {"queue_delay_us": 0.0, "pool_ratio": 0.0,
                        "queue_depth": 0.0}
            monkeypatch.setattr(sup, "_pressures", lambda: dict(pressure))
            sup._update_degradation()
            assert sup.level == 0 and batcher.brownout == 0
            assert sup.engine.degraded_clamp is None
            pressure["queue_delay_us"] = 60_000.0      # level 1
            sup._update_degradation()
            assert sup.level == 1 and batcher.brownout == 1
            assert sup.engine.degraded_clamp is None
            assert sup.state == "degraded"
            pressure["pool_ratio"] = 0.99              # straight to 3
            sup._update_degradation()
            assert sup.level == 3 and sup.engine.degraded_clamp == 7
            ev, toks = threading.Event(), []
            sup.submit([1, 2, 3, 4, 5], 50, toks.append,
                       lambda e: ev.set())
            assert ev.wait(30)
            assert len(toks) == 7, f"clamp not applied: {len(toks)} tokens"
            done = threading.Event()
            sup.submit(list(range(60, 72)), 1, lambda t: None,
                       lambda e: done.set())
            assert done.wait(30)
            assert sup.join_idle(10)
            sup._update_degradation()
            assert store.evictions > ev0, \
                "aggressive eviction never fired at level 3"
            assert sup.stats()["ladder_evictions"] > 0
            pressure.update(queue_delay_us=0.0, pool_ratio=0.0)
            sup._update_degradation()
            assert sup.level == 3, "de-escalated without hysteresis"
            sup._update_degradation()
            assert sup.level == 2
            for _ in range(4):
                sup._update_degradation()
            assert sup.level == 0 and batcher.brownout == 0
            assert sup.engine.degraded_clamp is None
            assert sup.state == "healthy"
        finally:
            _close(sup, store)
            batcher.close()

    def test_level_floor_holds_the_batcher_in_brownout(self):
        store, batcher, sup = self._mk()
        try:
            sup.set_level_floor(1)
            sup._update_degradation()
            assert sup.level == 1 and batcher.brownout == 1
            apply_level_to_components(1, supervisor=sup)
            assert sup._ladder.floor == 0
        finally:
            _close(sup, store)
            batcher.close()
        assert batcher.brownout == 0     # close undid the brownout

    def test_brownout_sheds_lowest_lane_only(self):
        batcher = DynamicBatcher(lambda x: np.asarray(x).sum(axis=1),
                                 max_batch_size=4, max_delay_us=500,
                                 length_buckets=(16,), name="tsup_bo_b")
        try:
            shed0 = batcher.brownout_shed.get_value()
            batcher.brownout = 1
            with pytest.raises(errors.RpcError) as ei:
                batcher.submit_wait([1.0, 2.0], timeout_s=5.0)
            assert ei.value.code == errors.ELIMIT
            assert "brownout" in ei.value.text
            assert batcher.brownout_shed.get_value() == shed0 + 1
            out = batcher.submit_wait([1.0, 2.0], timeout_s=5.0,
                                      deadline_s=time.monotonic() + 5.0)
            assert float(out) == 3.0
            batcher.brownout = 0
            assert float(batcher.submit_wait([2.0, 2.0],
                                             timeout_s=5.0)) == 4.0
        finally:
            batcher.close()


def test_overload_ladder_levels_equal_the_reference():
    """A seeded pressure sequence (with a floor change midway) through
    both packages' ladders: the same level at every tick, the same
    counters after."""
    th = ({"queue_delay_us": 50_000.0, "pool_ratio": 0.75},
          {"queue_delay_us": 100_000.0, "pool_ratio": 0.88},
          {"queue_delay_us": 200_000.0, "pool_ratio": 0.96})
    port, ref = OverloadLadder(th, hysteresis_ticks=3), \
        RefLadder(th, hysteresis_ticks=3)
    rng = np.random.default_rng(3)
    for tick in range(400):
        if tick == 200:
            port.floor = ref.floor = 2
        if tick == 300:
            port.floor = ref.floor = 0
        p = {"queue_delay_us": float(rng.uniform(0, 250_000)),
             "pool_ratio": float(rng.uniform(0, 1.0))}
        if rng.random() < 0.5:
            p = {k: v / 4 for k, v in p.items()}      # calm stretches
        assert port.update(p) == ref.update(p), tick
    want = ref.stats()
    assert want["level_names"] == []         # no display names given
    assert port.stats() == want


class TestClaimRetryRegression:
    def test_claim_retry_is_atomic_per_attempt(self):
        """Two failure paths racing to retry the same attempt resolve to
        exactly ONE retry chain."""
        cntl = Controller()
        wins = []
        barrier = threading.Barrier(2)

        def claim():
            barrier.wait()
            wins.append(cntl.claim_retry(0))

        ts = [threading.Thread(target=claim) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(5)
        assert sorted(wins) == [False, True]
        assert cntl.current_attempt == 1
        assert cntl.retried_count == 1
        assert cntl.claim_retry(0) is False       # stale owners never claim
        assert cntl._try_complete()
        assert cntl.claim_retry(1) is False       # completion closes it
