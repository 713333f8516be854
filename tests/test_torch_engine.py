"""The port's DecodeEngine held against the JAX package's dense oracle.

A port engine over a port runner (parameters carried over from the JAX
package by ``params_from_jax``) must stream exactly the tokens of
``brpc_tpu.models.runner.dense_generate`` for the same prompts: cold,
warm (prefix hit), and with several requests sharing the fixed-shape
step.  Plus the engine's request contract (EREQUEST, ELIMIT, ELOGOFF,
EINTERNAL, EOVERCROWDED), and a subprocess check that the port runs
with neither ``jax`` nor ``brpc_tpu`` imported.
"""
import os
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

import brpc_tpu_torch._core.build as core_build
from brpc_tpu_torch import errors
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.serving import DecodeEngine

from test_torch_runner import NEW, PROMPTS, TCFG, _tparams, jax_oracle

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Served:
    def __init__(self, name, num_slots=2, emit_buffer=256, eos_token=None,
                 max_pages_per_slot=24):
        self.params = _tparams()
        self.store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16,
                                      device=CPU, name=name)
        self.runner = T.TransformerRunner(self.params, TCFG,
                                          store=self.store, device=CPU)
        self.engine = DecodeEngine(
            runner=self.runner, store=self.store, num_slots=num_slots,
            max_pages_per_slot=max_pages_per_slot, prefill_buckets=(8, 16),
            eos_token=eos_token, emit_buffer=emit_buffer, device=CPU,
            name=name)

    def submit(self, prompt, n, emit=None):
        rec = {"toks": [], "errs": [], "ev": threading.Event()}
        self.engine.submit(
            prompt, n, emit or rec["toks"].append,
            lambda e: (rec["errs"].append(e), rec["ev"].set()))
        return rec

    def close(self):
        self.engine.close()
        self.store.clear()
        assert self.store.pagepool.blocks_leased() == 0, \
            "pool not back at baseline"


def _done(rec, timeout=60):
    assert rec["ev"].wait(timeout), "generation hung"
    return rec


def _ok(rec):
    _done(rec)
    assert rec["errs"] == [None], rec["errs"]
    return rec["toks"]


def test_streams_equal_jax_dense_generate_cold_then_warm():
    """Two requests decode side by side in one step: each stream equals
    the JAX oracle; the same prompts again hit the cached prefix and
    stream the same tokens."""
    srv = _Served("t_torch_eng_e2e")
    try:
        want = [jax_oracle(tuple(p), NEW) for p in PROMPTS]
        cold = [srv.submit(p, NEW) for p in PROMPTS]
        assert [_ok(r) for r in cold] == want
        hit0 = srv.store.hit_tokens
        warm = [srv.submit(p, NEW) for p in PROMPTS]
        assert [_ok(r) for r in warm] == want
        assert srv.store.hit_tokens - hit0 >= 4 * len(PROMPTS), \
            "warm run did not hit the cached prefix"
        st = srv.engine.stats()
        assert st["tokens"] == 2 * NEW * len(PROMPTS)
        assert st["steps"] > 0 and st["step_seconds"] > 0
    finally:
        srv.close()


def test_more_requests_than_slots_queue_and_match():
    """Four requests on two slots: the later ones wait for a step
    boundary with a free slot; every stream still equals the oracle."""
    srv = _Served("t_torch_eng_queue")
    try:
        prompts = list(PROMPTS) * 2
        recs = [srv.submit(p, NEW) for p in prompts]
        assert [_ok(r) for r in recs] == \
            [jax_oracle(tuple(p), NEW) for p in prompts]
        assert srv.engine.join_idle(10)
        assert srv.engine.stats()["retired"] == 4
    finally:
        srv.close()


def test_port_dense_generate_is_the_oracle_for_longer_runs():
    """A longer generation than the JAX oracle covers: the engine stream
    equals the port's own dense_generate."""
    srv = _Served("t_torch_eng_long", num_slots=3)
    try:
        prompts = ([9, 8, 7, 6, 5], [1, 2, 3], list(range(20, 33)))
        recs = [srv.submit(p, 9) for p in prompts]
        for p, r in zip(prompts, recs):
            assert _ok(r) == T.dense_generate(srv.params, TCFG, p, 9,
                                              device=CPU)
    finally:
        srv.close()


def test_bad_requests_fail_with_erequest_and_closed_with_elogoff():
    srv = _Served("t_torch_eng_bad")
    try:
        r0 = _done(srv.submit([1, 2, 3], 0))
        r1 = _done(srv.submit([], 4))
        assert [e.code for e in r0["errs"] + r1["errs"]] == \
            [errors.EREQUEST, errors.EREQUEST]
        too_long = _done(srv.submit(list(range(200)), 2))
        assert too_long["errs"][0].code == errors.ELIMIT
        assert srv.engine.stats()["admit_errors"] == 1
    finally:
        srv.close()
    late = _done(srv.submit([1, 2], 2))
    assert late["errs"][0].code == errors.ELOGOFF


def test_eos_token_ends_the_stream():
    want = jax_oracle(tuple(PROMPTS[0]), NEW)
    # the first token that did not appear earlier in the stream
    k = next(i for i in range(1, NEW) if want[i] not in want[:i])
    srv = _Served("t_torch_eng_eos", eos_token=want[k])
    try:
        assert _ok(srv.submit(PROMPTS[0], NEW)) == want[:k + 1]
    finally:
        srv.close()


def test_raising_emit_retires_only_that_request():
    srv = _Served("t_torch_eng_emit")
    try:
        def boom(tok):
            raise RuntimeError("consumer gone")

        bad = srv.submit(PROMPTS[0], NEW, emit=boom)
        good = srv.submit(PROMPTS[1], NEW)
        _done(bad)
        assert bad["errs"][0].code == errors.EINTERNAL
        assert _ok(good) == jax_oracle(tuple(PROMPTS[1]), NEW)
    finally:
        srv.close()


def test_slow_consumer_is_cut_with_eovercrowded():
    """A consumer that stops draining fills its one-token buffer and is
    cut at a step boundary; its step-mate streams on."""
    srv = _Served("t_torch_eng_slow", emit_buffer=1)
    gate = threading.Event()
    try:
        slow = srv.submit(PROMPTS[0], 8, emit=lambda t: gate.wait(30))
        fast = srv.submit(PROMPTS[1], NEW)
        assert _ok(fast) == jax_oracle(tuple(PROMPTS[1]), NEW)
        gate.set()
        _done(slow)
        assert slow["errs"][0].code == errors.EOVERCROWDED
        assert srv.engine.stats()["emit_cut"] == 1
    finally:
        gate.set()
        srv.close()


def test_close_finishes_in_flight_with_elogoff():
    srv = _Served("t_torch_eng_close", num_slots=1)
    gate = threading.Event()
    first = srv.submit(PROMPTS[0], 50, emit=lambda t: gate.wait(30))
    queued = srv.submit(PROMPTS[1], 2)
    srv.close()
    gate.set()
    assert _done(first)["errs"][0].code == errors.ELOGOFF
    assert _done(queued)["errs"][0].code == errors.ELOGOFF


def test_engine_rejects_mismatched_store_and_device():
    tp = _tparams()
    store = T.make_store_for(TCFG, page_tokens=4, device=CPU,
                             name="t_torch_eng_dev")
    runner = T.TransformerRunner(tp, TCFG, device=CPU)
    with pytest.raises(ValueError):
        DecodeEngine(runner=runner, store=None, device=CPU)
    with pytest.raises(ValueError):
        DecodeEngine(runner=runner, store=store, num_slots=0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DecodeEngine(runner=runner, store=store)


def test_port_runs_without_jax_or_brpc_tpu():
    """In a fresh interpreter: importing the port (its speculative module,
    its RPC front, its Serving service, the batcher, the supervisor,
    tensorframe, bvar and fault, the client policies, the combo
    channels, the PS shards, the training plane and the PS model,
    recordio, rpc_dump, rpc_replay and the flight recorder, the router
    tier, its WAL, the ``_cluster`` and ``_telemetry`` services, the model
    plane, router_proc, rpc_press and ``LegacyFnRunner`` too), serving
    one CPU request through a speculative engine, one
    ``Serving.Generate`` over loopback through the port's own server and
    channel (the engine behind an ``EngineSupervisor`` with an endpoint
    to quarantine), and one ``Serving.ScoreT`` through a
    ``DynamicBatcher`` over the runner, called through a
    ``prefix_affinity`` cluster channel (captured by ``rpc_dump`` with
    its span in the span database, and replayed) and a
    ``ParallelChannel``, and one Adam ``PS.UpdateT`` and ``PS.LookupT``
    through a ``PSClient``, one KV page migration into a
    ``Server(enable_dcn=True)``, and the HTTP face
    (``builtin.services``, ``rpc.http``, ``builtin.sampler``:
    ``/status`` and a chunked ``/serving/generate`` through the port's
    ``HttpChannel``), leaves jax and the JAX package out of sys.modules
    (and torch, until the first module past the router tier);
    the only native core mapped is the port's own build.  The SLO
    engine and the deployment registry load without torch too, and the
    training arbiter imports with the rest."""
    code = textwrap.dedent("""
        import json, sys, threading
        import numpy as np
        # the router tier (and the RPC front under it) loads without
        # torch: a router process starts without its import
        import brpc_tpu_torch.serving.router_proc
        # so do the SLO engine and the deployment registry
        import brpc_tpu_torch.serving.slo, brpc_tpu_torch.models.registry
        assert "torch" not in sys.modules
        import brpc_tpu_torch
        import brpc_tpu_torch.train.arbiter
        import brpc_tpu_torch.rpc as rpc
        import brpc_tpu_torch.bvar, brpc_tpu_torch.fault
        import brpc_tpu_torch.rpc.tensorframe
        import brpc_tpu_torch.butil.doubly_buffered
        import brpc_tpu_torch.policy.cluster_recover_policy
        import brpc_tpu_torch.policy.naming
        import brpc_tpu_torch.rpc.combo_channels
        import brpc_tpu_torch.psserve, brpc_tpu_torch.train
        import brpc_tpu_torch.models.parameter_server
        import brpc_tpu_torch.builtin.services, brpc_tpu_torch.rpc.http
        import brpc_tpu_torch.builtin.sampler
        import brpc_tpu_torch.tools.parallel_http
        import brpc_tpu_torch.tools.rpc_view
        import brpc_tpu_torch.serving.router, brpc_tpu_torch.serving.session_wal
        import brpc_tpu_torch.serving.cluster_control
        import brpc_tpu_torch.serving.telemetry
        import brpc_tpu_torch.serving.modelplane
        import brpc_tpu_torch.serving.router_proc
        import brpc_tpu_torch.tools.rpc_press
        from brpc_tpu_torch.models import LegacyFnRunner
        import os, tempfile
        from brpc_tpu_torch import flags, rpcz
        from brpc_tpu_torch.butil import flight, recordio
        from brpc_tpu_torch.rpc import rpc_dump
        from brpc_tpu_torch.tools import rpc_replay
        from brpc_tpu_torch.train.trainer import DataParallelTrainer
        from brpc_tpu_torch.butil.endpoint import EndPoint
        from brpc_tpu_torch.policy import health_check
        from brpc_tpu_torch.policy.circuit_breaker import global_breaker
        from brpc_tpu_torch.serving import (DynamicBatcher,
            EngineSupervisor, ScoreClient)
        from brpc_tpu_torch.models import (TransformerConfig,
            TransformerRunner, init_runner_params, make_store_for)
        from brpc_tpu_torch.serving import DecodeEngine
        from brpc_tpu_torch.serving.service import register_serving
        from brpc_tpu_torch.serving.speculative import NGramProposer
        cfg = TransformerConfig()
        store = make_store_for(cfg, page_tokens=4, device="cpu")
        runner = TransformerRunner(init_runner_params(cfg, device="cpu"),
                                   cfg, store=store, device="cpu")
        eng = DecodeEngine(runner=runner, store=store, num_slots=2,
                           prefill_buckets=(8,), device="cpu",
                           draft_runner=NGramProposer(), draft_len=2)
        toks, done = [], threading.Event()
        eng.submit([1, 2, 3], 2, toks.append, lambda e: done.set())
        assert done.wait(60) and len(toks) == 2, toks
        sup = EngineSupervisor(lambda: eng, store=store,
                               endpoint=EndPoint("127.0.0.1", 1),
                               quarantine_after=3)
        assert sup.stats()["quarantined"] is False
        batcher = DynamicBatcher(runner, max_batch_size=2,
                                 length_buckets=(8,), dtype=np.int32)
        server = rpc.Server()
        register_serving(server, batcher=batcher, engine=sup)
        server.start("127.0.0.1", 0)
        msgs, closed = [], threading.Event()

        class Collect(rpc.StreamHandler):
            def on_received_messages(self, stream, batch):
                msgs.extend(json.loads(m) for m in batch)

            def on_closed(self, stream):
                closed.set()

        cntl = rpc.Controller()
        rpc.stream_create(cntl, Collect())
        resp = rpc.Channel(f"127.0.0.1:{server.port}",
                           timeout_ms=30000).call_sync(
            "Serving", "Generate", {"prompt": [1, 2, 3],
                                    "max_new_tokens": 2},
            serializer="json", cntl=cntl)
        assert resp["accepted"] and closed.wait(60), (resp, msgs)
        assert [m["token"] for m in msgs if "token" in m] == toks, msgs
        assert msgs[-1] == {"done": True}, msgs
        cluster = rpc.Channel(f"list://127.0.0.1:{server.port}",
                              timeout_ms=30000,
                              load_balancer="prefix_affinity")
        # the ScoreT call captured by rpc_dump, its span in the span
        # database, then replayed
        tmp = tempfile.mkdtemp()
        flags.set_flag("rpc_dump_dir", tmp, force=True)
        flags.set_flag("rpc_dump", True, force=True)
        rpcz.set_enabled(True)
        rpcz.set_database_dir(os.path.join(tmp, "spans"))
        y = ScoreClient(cluster).score([1, 2, 3])
        flags.set_flag("rpc_dump", False, force=True)
        rpc_dump.RpcDumper.instance().close()
        assert len(rpc_replay.load_records(tmp)) == 1
        summary = rpc_replay.run_replay(f"127.0.0.1:{server.port}", tmp,
                                        timeout_ms=30000, out=sys.stdout)
        assert summary["replayed"] == 1 and summary["errors"] == 0, summary
        rpcz.flush()
        assert "server" in [s.kind for s in rpcz.load_disk_spans(50)]
        rpcz.set_database_dir(None)
        rpcz.set_enabled(False)
        assert flight.available() and flight.events(8)
        assert recordio.MAGIC == b"RIO1"
        assert y.shape == (3,) and int(y[-1]) == toks[0], (y, toks)
        fan = rpc.ParallelChannel().add_channel(cluster)
        out = fan.call_sync("Serving", "Score", {"x": [1, 2, 3]},
                            serializer="json")
        assert [int(v) for v in out[0]["y"]] == [int(v) for v in y], out
        web = rpc.HttpChannel(f"127.0.0.1:{server.port}")
        assert b"Serving.Generate" in web.get("/status").body
        pieces = []
        reader = web.request_stream(
            "GET", "/serving/generate?prompt=1,2,3&max_new_tokens=2",
            on_data=pieces.append)
        assert reader.wait(60) and reader.error is None, reader.error
        lines = [json.loads(x) for x in b"".join(pieces).splitlines()]
        assert [m["token"] for m in lines if "token" in m] == toks, lines
        web.close()
        assert global_breaker() is not None
        from brpc_tpu_torch import psserve
        from brpc_tpu_torch.train import OptimizerSpec
        shard = psserve.EmbeddingShardServer(0, 1, 16, 4, device="cpu")
        ps = rpc.Server()
        psserve.register_psserve(ps, shard)
        ps.start("127.0.0.1", 0)
        pc = rpc.PartitionChannel(1)
        pc.add_partition(0, rpc.Channel(f"127.0.0.1:{ps.port}",
                                        timeout_ms=30000))
        pcli = psserve.PSClient(pc, vocab=16, dim=4)
        pcli.update([1, 2, 1], np.ones((3, 4), np.float32),
                    optimizer=OptimizerSpec("adam", lr=0.1))
        assert pcli.lookup([1]).shape == (1, 4)
        assert shard.stats()["opt_slots"] == ["m", "t", "v"]
        # no call broke an endpoint; checked before the shutdown, whose
        # closed connection marks the PS endpoint broken on the client's
        # own callback thread
        assert not health_check.broken_endpoints()
        ps.stop(); ps.join()
        import brpc_tpu_torch.migrate as mig
        from brpc_tpu_torch.models.runner import run_prefill
        p9 = list(range(1, 10))
        seq = store.admit(p9)
        run_prefill(runner, seq, p9)
        store.retire(seq, cache=True)
        dst = make_store_for(cfg, page_tokens=4, device="cpu", name="dst")
        mig_srv = rpc.Server(enable_dcn=True, dcn_device="cpu")
        mig.register_migration(mig_srv, dst)
        mig_srv.start("127.0.0.1", 0)
        assert mig.PageMigrator(store).migrate(
            p9, f"127.0.0.1:{mig_srv.port}") == 2
        assert dst.probe(p9) == 8
        mig_srv.stop(); mig_srv.join()
        server.stop(); server.join(); sup.close(); batcher.close()
        cores = sorted({ln.split()[-1].rsplit("/", 1)[-1]
                        for ln in open("/proc/self/maps")
                        if "libbrpc_core" in ln})
        print("CORES", cores)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "brpc_tpu"))
        print("LEAKED", bad)
        sys.exit(1 if bad or cores != ["libbrpc_core_torch.so"] else 0)
    """)
    # the port's native core is compiled here (g++ only; nothing is
    # loaded), so the child's time goes to the imports and the requests
    core_build.build()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_concurrent_submitters_and_cancels_leave_no_leak():
    """Many submitter threads (more than cores), some consumers dying
    mid-stream, a short switch interval: every request finishes exactly
    once, every clean stream equals the port's dense oracle, and the
    page pool returns to its baseline."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    srv = _Served("t_torch_eng_stress", num_slots=3, max_pages_per_slot=8)
    try:
        prompts = [[(7 * i + j) % TCFG.vocab for j in range(3 + i % 5)]
                   for i in range(24)]
        want = {tuple(p): T.dense_generate(srv.params, TCFG, p, 4,
                                           device=CPU) for p in prompts}
        done = {}
        lock = threading.Lock()

        def client(i, p):
            toks, calls, ev = [], [], threading.Event()

            def emit(t):
                if i % 4 == 3 and len(toks) == 1:
                    raise RuntimeError("consumer died")
                toks.append(t)

            def on_done(e):
                calls.append(e)
                ev.set()

            srv.engine.submit(p, 4, emit, on_done)
            assert ev.wait(60), f"request {i} hung"
            with lock:
                done[i] = (toks, calls)

        threads = [threading.Thread(target=client, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        assert not any(t.is_alive() for t in threads)
        assert srv.engine.join_idle(10)
        for i, p in enumerate(prompts):
            toks, calls = done[i]
            assert len(calls) == 1, f"request {i}: on_done x{len(calls)}"
            if i % 4 == 3:
                assert calls[0].code == errors.EINTERNAL
            else:
                assert calls[0] is None and toks == want[tuple(p)]
        srv.store.pagepool.assert_consistent()
    finally:
        sys.setswitchinterval(old)
        srv.close()
