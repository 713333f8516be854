"""The port's disaggregated prefill/decode and cross-process failover
(``brpc_tpu_torch/migrate/disagg.py``) held against the JAX package's.

Counterparts of ``tests/test_disagg.py`` on port replicas with REAL K/V
(``TransformerConfig()``, the JAX package's parameters through
``params_from_jax``): the split generation over a ``DisaggCoordinator``
(the prefill replica's ``TransformerRunner`` prefills, its pages ship to
the decode replica, whose engine prefix-hits them), repeat prompts, the
recompute fallback under ``fault.MIGRATE_SEND``, concurrent splits;
failover through ``StandbySync`` to a standby whose engine is an
``EngineSupervisor`` (its submit takes no trace context): exactly once,
a replay of only what the client missed with a second assume refused, a
transient sync failure that heals, and a pure replay after a clean
finish.  The primary is killed by a ``fault.STEP`` crash at a fixed
step, so the crash window is the same on every run.

The reference's ``test_disagg_prefill_reuses_batcher`` runs on
harness-mode stores (token ids as page payloads) with the reference's
step function, its prefill through a ``DynamicBatcher``: every stream is
the step function's oracle, as the JAX package's.
``test_press_disagg_mode`` waits for ``tools/`` (item 6h).  Tolerances: greedy tokens are exact, held to the
JAX package's teacher-forced dense forward and to the port's oracle.
"""
import threading

import numpy as np
import pytest

from brpc_tpu_torch import errors, fault, rpc
from brpc_tpu_torch.ici import dcn
from brpc_tpu_torch.migrate import (DisaggCoordinator, StandbySync,
                                    assume_stream, register_disagg_decode,
                                    register_disagg_prefill,
                                    register_standby)
from brpc_tpu_torch.serving import DecodeEngine, EngineSupervisor

from test_torch_migrate import (CPU, PT, assert_jax_greedy, mk_store,
                                pages_of, port_oracle, prompt_at, runner_for)

CALM_LADDER = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
                "queue_depth": 1e9},) * 3


def engine_on(store, name):
    return DecodeEngine(runner=runner_for(store), store=store, num_slots=4,
                        prefill_buckets=(16,), device=CPU, name=name)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    fault.clear()
    yield
    fault.clear()


@pytest.fixture(scope="module")
def split():
    """One prefill server and one decode server, in-process loopback."""
    dstore = mk_store("dg_dec", max_blocks=16)
    eng = engine_on(dstore, "dg_dec")
    dsrv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    register_disagg_decode(dsrv, dstore, eng)
    dsrv.start("127.0.0.1", 0)
    decode_addr = f"127.0.0.1:{dsrv.port}"
    pstore = mk_store("dg_pre", max_blocks=16)
    psrv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    replica = register_disagg_prefill(psrv, pstore, decode_addr,
                                      runner=runner_for(pstore))
    psrv.start("127.0.0.1", 0)
    co = DisaggCoordinator(f"127.0.0.1:{psrv.port}", decode_addr,
                           device=CPU)
    yield {"co": co, "replica": replica, "pstore": pstore,
           "dstore": dstore}
    eng.close()
    for srv in (psrv, dsrv):
        srv.stop()
        srv.join()
    for st in (pstore, dstore):
        st.clear()
        assert st.pagepool.blocks_leased() == 0
        st.close()


def test_disagg_generation_bit_exact_with_page_handoff(split):
    co, dstore = split["co"], split["dstore"]
    ta, tb = co.pair()
    assert ta["magic"] == tb["magic"] == dcn.DCN_MAGIC
    assert ta["xfer"] is None and tb["platform"] == "cpu"
    h0 = dstore.hit_tokens
    prompt = prompt_at(50)                 # 13 tokens, 3 full pages
    streamed = []
    out = co.generate(prompt, 6, emit=streamed.append)
    assert out["error"] is None and streamed == out["tokens"]
    assert_jax_greedy(prompt, out["tokens"])
    assert out["tokens"] == port_oracle(tuple(prompt), 6)
    info = out["prefill"]
    assert info == {"cursor": 13, "prefix_hit": 0, "migrated_pages": 3,
                    "recompute_fallback": False}
    # the decode side never re-prefilled the full-page prefix: it holds
    # the prefill replica's K/V, byte for byte
    assert out["prefix_hit"] == 3 * PT
    assert dstore.hit_tokens - h0 == 3 * PT
    assert pages_of(dstore, prompt) == pages_of(split["pstore"], prompt)
    assert split["replica"].stats()["fallbacks"] == 0


def test_disagg_repeat_prompts_skip_prefill_side_too(split):
    co, pstore = split["co"], split["pstore"]
    prompt = prompt_at(70)
    assert co.generate(prompt, 3)["error"] is None
    p0 = pstore.hit_tokens
    out = co.generate(prompt, 3)
    assert out["error"] is None
    assert out["tokens"] == port_oracle(tuple(prompt), 3)
    assert out["prefill"]["prefix_hit"] == 3 * PT
    assert pstore.hit_tokens - p0 == 3 * PT


def test_disagg_concurrent_generations(split):
    co = split["co"]
    prompts = [prompt_at(90 + 13 * i, 9 + i) for i in range(4)]
    outs = [None] * 4

    def run(i):
        outs[i] = co.generate(prompts[i], 3)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for p, out in zip(prompts, outs):
        assert out is not None and out["error"] is None
        assert out["tokens"] == port_oracle(tuple(p), 3)
        assert out["prefill"]["migrated_pages"] == len(p) // PT


def test_disagg_migration_failure_recompute_fallback(split):
    co, dstore, replica = split["co"], split["dstore"], split["replica"]
    prompt = prompt_at(110)
    h0, f0 = dstore.hit_tokens, replica.stats()["fallbacks"]
    plan = fault.FaultPlan(3).on(fault.MIGRATE_SEND, fault.ERROR, times=-1)
    with fault.injected(plan):
        out = co.generate(prompt, 5)
    assert out["error"] is None
    assert out["tokens"] == port_oracle(tuple(prompt), 5)
    assert out["prefill"]["recompute_fallback"] is True
    assert out["prefill"]["migrated_pages"] == 0
    assert dstore.hit_tokens == h0            # cold admit: no hit
    assert replica.stats()["fallbacks"] == f0 + 1


def test_disagg_prefill_without_runner_raises_naming_item_7():
    """The refusal this name records is gone: ``batcher=`` without
    ``runner=`` now builds a prefill replica that prefills through the
    batcher (``test_disagg_prefill_reuses_batcher`` drives it)."""
    store = mk_store("dg_nobatch")
    try:
        b = object()
        replica = register_disagg_prefill(rpc.Server(), store,
                                          "127.0.0.1:1", batcher=b)
        assert replica.batcher is b and replica.runner is None
        assert replica.stats() == {"prefills": 0, "fallbacks": 0,
                                   "decode_addr": "127.0.0.1:1"}
    finally:
        store.close()


def _harness_step(tokens, positions, pages=None):
    # the reference test's position-dependent step
    return (np.asarray(tokens) * 7 + np.asarray(positions)) % 997


def _harness_expected(prompt, n):
    last, pos, out = prompt[-1], len(prompt), []
    for _ in range(n):
        last = (last * 7 + pos) % 997
        out.append(last)
        pos += 1
    return out


def test_disagg_prefill_reuses_batcher():
    """Concurrent Prefill RPCs coalesce through the caller's
    DynamicBatcher; the split generations are the step function's."""
    from brpc_tpu.tools.rpc_press import expected_model_tokens
    from brpc_tpu_torch.ici.block_pool import BlockPool
    from brpc_tpu_torch.kvcache import KVCacheStore
    from brpc_tpu_torch.serving import DynamicBatcher
    calls = []

    def counting_fn(x):
        calls.append(np.asarray(x).shape[0])
        return np.asarray(x).sum(axis=-1)

    def harness_store(name):
        return KVCacheStore(BlockPool(CPU), page_tokens=PT, page_bytes=256,
                            max_blocks=32, name=name, vector_kv=False)

    batcher = DynamicBatcher(counting_fn, max_batch_size=8,
                             max_delay_us=30_000, length_buckets=(16,),
                             name="tdg_prefill_b")
    dstore = harness_store("tdg_dec_b")
    eng = DecodeEngine(_harness_step, num_slots=4, store=dstore,
                       max_pages_per_slot=32, device=CPU,
                       name="tdg_eng_b")
    dsrv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    register_disagg_decode(dsrv, dstore, eng)
    dsrv.start("127.0.0.1", 0)
    pstore = harness_store("tdg_pre_b")
    psrv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    replica = register_disagg_prefill(psrv, pstore,
                                      f"127.0.0.1:{dsrv.port}",
                                      batcher=batcher)
    psrv.start("127.0.0.1", 0)
    try:
        co = DisaggCoordinator(f"127.0.0.1:{psrv.port}",
                               f"127.0.0.1:{dsrv.port}", device=CPU)
        outs = [None] * 4
        prompts = [[90 + 100 * i + j for j in range(9)] for i in range(4)]

        def run(i):
            outs[i] = co.generate(prompts[i], 3)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for i, out in enumerate(outs):
            assert out is not None and out["error"] is None
            assert out["tokens"] == _harness_expected(prompts[i], 3)
            # the JAX package's oracle of the same rule
            assert out["tokens"] == expected_model_tokens(prompts[i], 3, 7)
            assert out["prefill"]["migrated_pages"] == 2   # 9 tokens, PT 4
        st = batcher.stats()
        assert st["completed"] == 4 and st["batches"] >= 1
        assert sum(calls) == 4 and replica.stats()["prefills"] == 4
    finally:
        eng.close()
        batcher.close()
        psrv.stop()
        psrv.join()
        dsrv.stop()
        dsrv.join()
        for store in (pstore, dstore):
            store.clear()
            store.close()


# ---------------------------------------------------------------------------
# cross-process failover
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def standby():
    """A standby replica whose engine is an EngineSupervisor."""
    sstore = mk_store("sb_store", max_blocks=16)
    sup = EngineSupervisor(lambda: engine_on(sstore, "sb_eng"), store=sstore,
                           check_interval_s=0.02, ladder=CALM_LADDER,
                           name="sb_sup")
    ssrv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    replica = register_standby(ssrv, sstore, sup)
    ssrv.start("127.0.0.1", 0)
    yield {"replica": replica, "store": sstore,
           "addr": f"127.0.0.1:{ssrv.port}"}
    ssrv.stop()
    ssrv.join()
    sup.close()
    sstore.clear()
    assert sstore.pagepool.blocks_leased() == 0
    sstore.close()


@pytest.fixture()
def primary(standby):
    pstore = mk_store("pr_store", commit_live_pages=True)
    peng = engine_on(pstore, "pr_eng")
    sync = StandbySync(pstore, standby["addr"], submit_fn=peng.submit,
                       name="pr_sync")
    yield sync, peng, pstore
    sync.close()
    peng.close()
    pstore.clear()
    assert pstore.pagepool.blocks_leased() == 0
    pstore.close()
    standby["store"].clear()


def crash_after(k):
    """The primary engine's (k+1)-th decode step crashes: the generation
    fails over with EINTERNAL after k tokens."""
    return fault.FaultPlan(5).on(
        fault.STEP, fault.ERROR, times=1, after=k,
        match=lambda c: c.get("name") == "pr_eng")


def run_primary(sync, prompt, budget, crash=None):
    got, errs, done = [], [], threading.Event()
    if crash is None:
        sid = sync.submit(prompt, budget, got.append,
                          lambda e: (errs.append(e), done.set()))
        assert done.wait(30)
    else:
        with fault.injected(crash_after(crash)):
            sid = sync.submit(prompt, budget, got.append,
                              lambda e: (errs.append(e), done.set()))
            assert done.wait(30)
    assert sync.flush(10)
    return sid, got, errs[0]


def test_failover_completes_exactly_once_bit_exact(primary, standby):
    sync, _, _ = primary
    prompt, budget = prompt_at(30), 10
    sid, got, err = run_primary(sync, prompt, budget, crash=4)
    assert err is not None and err.code == errors.EINTERNAL
    assert len(got) == 4
    out = assume_stream(standby["addr"], sid, len(got))
    assert out["error"] is None
    full = got + out["tokens"]
    assert full == port_oracle(tuple(prompt), budget)
    assert_jax_greedy(prompt, full)
    assert len(out["tokens"]) == budget - len(got)
    assert out["replayed"] == 0
    # the shipped pages made the resume a partial re-decode
    assert out["resume_prefix_hit"] >= 3 * PT
    assert standby["replica"].stats()["assumed"] >= 1


def test_failover_replays_only_what_the_client_missed(primary, standby):
    sync, _, _ = primary
    prompt, budget = prompt_at(130), 8
    sid, got, err = run_primary(sync, prompt, budget, crash=5)
    assert err.code == errors.EINTERNAL and len(got) == 5
    cursor = len(got) - 2           # the client lost its last two tokens
    out = assume_stream(standby["addr"], sid, cursor)
    assert out["error"] is None and out["replayed"] == 2
    assert got[:cursor] + out["tokens"] == port_oracle(tuple(prompt),
                                                       budget)
    with pytest.raises(errors.RpcError) as ei:
        assume_stream(standby["addr"], sid, cursor)
    assert ei.value.code == errors.EREQUEST and "already" in ei.value.text


def test_transient_sync_failure_self_heals_the_record(primary, standby):
    sync, _, _ = primary
    real_call = sync._call
    dropped = []

    def flaky_call(method_name, body):
        # the standby blips once, on the second token's sync
        if method_name == "Append" and int(body.get("cursor", 0)) == 1 \
                and not dropped:
            dropped.append(body)
            raise errors.RpcError(errors.EFAILEDSOCKET, "injected blip")
        return real_call(method_name, body)

    sync._call = flaky_call
    prompt, budget = prompt_at(330), 8
    try:
        sid, got, err = run_primary(sync, prompt, budget, crash=5)
    finally:
        sync._call = real_call
    assert dropped and sync.stats()["sync_errors"] == 1
    out = assume_stream(standby["addr"], sid, len(got))
    assert out["error"] is None
    assert got + out["tokens"] == port_oracle(tuple(prompt), budget)


def test_failover_after_clean_finish_is_pure_replay(primary, standby):
    sync, _, _ = primary
    prompt, budget = prompt_at(230, 9), 5
    sid, got, err = run_primary(sync, prompt, budget)
    assert err is None and got == port_oracle(tuple(prompt), budget)
    # a clean finish closes the record; a standby that outlived the
    # Finish is modelled by rebuilding it through the replica
    replica = standby["replica"]
    replica.begin(sid + 10_000, prompt, budget)
    replica.append(sid + 10_000, 0, got)
    replica.finish(sid + 10_000, 0)
    out = assume_stream(standby["addr"], sid + 10_000, 2)
    assert out["error"] is None and out["remaining"] == 0
    assert got[:2] + out["tokens"] == got
    assert out["replayed"] == budget - 2
    with pytest.raises(errors.RpcError, match="gap"):
        replica.append(sid + 10_000, 9, [1])
