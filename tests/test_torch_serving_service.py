"""The port's ``Serving`` service over its own TRPC server, held against
the JAX package.

  * the counterpart of test_model_runner.py's
    ``test_serving_generate_real_runner_prefill_skip_identical_tokens``:
    a port engine at ``TransformerConfig()`` on the CPU, parameters from
    the JAX package (``params_from_jax``), behind ``Serving.Generate``:
    the cold stream equals the JAX package's ``dense_generate`` token for
    token, ``prefix_hit`` is 0 cold and > 0 warm with identical warm
    tokens, and a JAX-package server (its engine, runner and service)
    streams the same tokens and reports the same ``prefix_hit`` for the
    same requests;
  * the counterparts of test_serving.py's slow-consumer cut (the client
    sees ``{"done": true, "error": 1011}`` while a fast reader beside it
    streams on) and ``test_rpc_generate_streams_tokens``;
  * ``"speculative": false`` reaches the engine; ``Score``/``ScoreT``
    answer ENOMETHOD without a batcher (``ScoreT`` on the tensorframe
    wire);
  * Score and ScoreT through a batcher over a runner, on a port server
    and on a JAX-package server over the same parameters: the same ids,
    equal to the JAX package's dense forward, with each package's
    ``ScoreClient`` against each server;
  * Generate through an ``EngineSupervisor`` streams the oracle;
  * shutdown (server, then engine, then store) while a stream is open:
    nothing hangs, no sequence stays live, the pool is at its baseline.
"""
import functools
import json
import threading
import time

import numpy as np
import pytest

import brpc_tpu as ref
from brpc_tpu.models import runner as R
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu.serving import DynamicBatcher as RefBatcher
from brpc_tpu.serving.service import ScoreClient as RefScoreClient
from brpc_tpu.serving.service import register_serving as ref_register
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.serving import (DecodeEngine, DynamicBatcher,
                                    EngineSupervisor, ScoreClient,
                                    register_serving)
from brpc_tpu_torch.serving.speculative import NGramProposer

from testutil import wait_until
from test_torch_runner import (JCFG, JPARAMS, NEW, PROMPTS, TCFG, _tparams,
                               jax_oracle)

CPU = "cpu"


@functools.cache
def port_oracle(prompt: tuple, n: int) -> list:
    """The port's dense oracle (held against the JAX package's by
    test_torch_runner.py)."""
    return T.dense_generate(_tparams(), TCFG, list(prompt), n, device=CPU)


class _Port:
    """A port engine over the JAX package's parameters behind a port
    Server on loopback."""

    def __init__(self, name, *, emit_buffer=256, draft=None, wrap=None):
        self.store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16,
                                      device=CPU, name=name)
        self.free0 = self.store.pagepool.pool.stats()["classes"]
        runner = T.TransformerRunner(_tparams(), TCFG, store=self.store,
                                     device=CPU, name=name)
        kw = {} if draft is None else {"draft_runner": draft,
                                       "draft_len": 3}
        self.engine = DecodeEngine(runner=runner, store=self.store,
                                   num_slots=2, max_pages_per_slot=24,
                                   prefill_buckets=(8, 16),
                                   emit_buffer=emit_buffer, device=CPU,
                                   name=name, **kw)
        self.server = rpc.Server()
        register_serving(self.server, engine=wrap(self.engine) if wrap
                         else self.engine)
        self.server.start("127.0.0.1", 0)
        self.port = self.server.port

    def close(self):
        # the documented order: server, engine, store
        self.server.stop()
        self.server.join()
        self.engine.close()
        self.store.clear()
        assert self.store.stats()["live_seqs"] == 0
        assert self.store.pagepool.blocks_leased() == 0
        assert self.store.pagepool.pool.stats()["classes"] == self.free0, \
            "pool not back at baseline"


class _Collector:
    """A Generate stream's messages; ``gate`` (when given) holds the
    first delivery until it is set -- a consumer that stopped
    draining."""

    def __init__(self, mod, gate=None):
        col = self
        self.msgs, self.done, self.gate = [], threading.Event(), gate

        class H(mod.StreamHandler):
            def on_received_messages(self, stream, messages):
                if col.gate is not None:
                    col.gate.wait(30)
                for m in messages:
                    d = json.loads(m)
                    col.msgs.append(d)
                    if d.get("done"):
                        col.done.set()

            def on_closed(self, stream):
                col.done.set()

        self.handler = H()

    @property
    def tokens(self):
        return [m["token"] for m in self.msgs if "token" in m]

    @property
    def terminal(self):
        return next((m for m in self.msgs if m.get("done")), None)


def _start(mod, port, body, gate=None):
    """Issue Generate through ``mod``'s Channel; returns (collector,
    response)."""
    col = _Collector(mod, gate)
    cntl = mod.Controller()
    mod.stream_create(cntl, col.handler)
    ch = mod.Channel(f"127.0.0.1:{port}", timeout_ms=30_000)
    resp = ch.call_sync("Serving", "Generate", body, serializer="json",
                        cntl=cntl)
    assert resp["accepted"] is True
    return col, resp


def _generate(mod, port, prompt, n, **extra):
    col, resp = _start(mod, port, {"prompt": prompt, "max_new_tokens": n,
                                   **extra})
    assert col.done.wait(120), "generation hung"
    assert col.terminal == {"done": True}, col.msgs
    return col.tokens, resp["prefix_hit"]


def test_generate_prefill_skip_identical_tokens_and_equal_to_reference():
    prompt = list(PROMPTS[0])
    srv = _Port("t_torch_svc_e2e")
    try:
        cold, hit0 = _generate(rpc, srv.port, prompt, NEW)
        assert hit0 == 0
        assert cold == jax_oracle(tuple(prompt), NEW)
        warm, hit1 = _generate(rpc, srv.port, prompt, NEW)
        assert hit1 > 0, "no advisory prefix hit on the warm call"
        assert warm == cold, "prefix reuse changed Serving.Generate output"
        # the JAX package's client gets the same from the port's server
        again, hit2 = _generate(ref, srv.port, prompt, NEW)
        assert (again, hit2) == (cold, hit1)
    finally:
        srv.close()
    # the same requests to a JAX-package server
    store = R.make_store_for(JCFG, page_tokens=4, max_blocks=16,
                             name="t_torch_svc_ref_kv")
    runner = R.TransformerRunner(JPARAMS, JCFG, store=store,
                                 name="t_torch_svc_ref")
    eng = RefEngine(runner=runner, num_slots=2, store=store,
                    max_pages_per_slot=24, prefill_buckets=(8, 16),
                    name="t_torch_svc_ref_eng")
    srv = ref.Server(has_builtin_services=False)
    ref_register(srv, engine=eng, http_generate_path=None)
    srv.start("127.0.0.1", 0)
    try:
        assert _generate(rpc, srv.port, prompt, NEW) == (cold, hit0)
        assert _generate(rpc, srv.port, prompt, NEW) == (warm, hit1)
    finally:
        srv.stop()
        srv.join()
        eng.close()
        store.clear()
        store.close()


@pytest.mark.parametrize("client", ["port", "ref"])
def test_rpc_generate_streams_tokens(client):
    """Either package's client streams the tokens, then the terminal."""
    srv = _Port(f"t_torch_svc_stream_{client}")
    try:
        mod = {"port": rpc, "ref": ref}[client]
        toks, _ = _generate(mod, srv.port, [7], 5)
        assert toks == port_oracle((7,), 5)
    finally:
        srv.close()


def test_slow_consumer_cut_with_eovercrowded_fast_reader_streams_on(
        monkeypatch):
    """A reader that stops draining fills the server's stream window
    (128 B here, so a few tokens fill it; the terminal message must fit
    it), its emitter blocks in the bounded write, its emit buffer
    overflows and the engine cuts it with EOVERCROWDED at a step
    boundary; the client sees ``{"done": true, "error": 1011}`` after
    its buffered tokens.  The fast reader beside it streams the oracle's
    tokens to the end."""
    monkeypatch.setattr(rpc.stream, "DEFAULT_BUF_SIZE", 128)
    srv = _Port("t_torch_svc_slow", emit_buffer=4)
    gate = threading.Event()
    try:
        slow, _ = _start(rpc, srv.port, {"prompt": [3, 1, 4],
                                         "max_new_tokens": 64}, gate=gate)
        fast, _ = _start(rpc, srv.port, {"prompt": [5, 9, 2],
                                         "max_new_tokens": 12})
        assert wait_until(lambda: srv.engine.stats()["emit_cut"] == 1, 30), \
            "the slow reader was never cut"
        gate.set()
        assert fast.done.wait(60) and slow.done.wait(60)
        assert fast.terminal == {"done": True}
        assert fast.tokens == port_oracle((5, 9, 2), 12)
        term = slow.terminal
        assert term is not None and term["error"] == errors.EOVERCROWDED
        assert slow.tokens == port_oracle((3, 1, 4), 64)[:len(slow.tokens)]
        assert 0 < len(slow.tokens) < 64
        assert srv.engine.join_idle(30)
    finally:
        gate.set()
        srv.close()


def test_speculative_false_is_forwarded():
    seen = []

    class Recording:
        """The engine, recording what each submit was given."""

        def __init__(self, engine):
            self._e = engine
            self.store = engine.store

        def submit(self, *a, **kw):
            seen.append(kw)
            return self._e.submit(*a, **kw)

    srv = _Port("t_torch_svc_spec", draft=NGramProposer(), wrap=Recording)
    try:
        prompt = [4, 8, 15, 16, 23, 42]
        want = port_oracle(tuple(prompt), 6)
        assert _generate(rpc, srv.port, prompt, 6,
                         speculative=False)[0] == want
        assert _generate(rpc, srv.port, prompt, 6)[0] == want
        assert seen == [{"speculative": False}, {}]
    finally:
        srv.close()


def test_score_without_batcher_and_generate_without_engine():
    srv = rpc.Server()
    register_serving(srv)
    srv.start("127.0.0.1", 0)
    try:
        for client in (rpc, ref):
            ch = client.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
            for meth, body, ser in (("Score", {"x": [1.0]}, "json"),
                                    ("ScoreT",
                                     {"x": np.ones(1, np.float32)},
                                     "tensorframe"),
                                    ("Generate", {"prompt": [1]}, "json")):
                with pytest.raises(Exception) as ei:
                    ch.call_sync("Serving", meth, body, serializer=ser)
                assert ei.value.code == errors.ENOMETHOD
                assert ("batcher" if meth.startswith("Score")
                        else "engine") in ei.value.text
    finally:
        srv.stop()
        srv.join()


def test_shutdown_with_an_open_stream():
    """Server stop/join with a generation mid-stream: the client's
    stream closes, the engine cancels the request, and close() leaves
    no live sequence and the pool at its baseline (asserted by
    ``_Port.close``)."""
    srv = _Port("t_torch_svc_shutdown")
    col, _ = _start(rpc, srv.port, {"prompt": [1, 2, 3],
                                    "max_new_tokens": 60000})
    assert wait_until(lambda: len(col.tokens) >= 3, 30)
    t0 = time.monotonic()
    srv.close()
    assert time.monotonic() - t0 < 30
    assert col.done.wait(30)
    assert wait_until(lambda: srv.engine.stats()["slots"] == [None, None],
                      30)
    assert col.tokens[:3] == port_oracle((1, 2, 3), 3)


# ---- Score / ScoreT through the batcher, both packages ----------------------

SCORE_ROWS = ([5, 17, 42, 9], [88, 12, 54, 61, 7, 30, 2])


def test_score_and_score_t_equal_across_packages_and_clients():
    """A batcher over each package's runner (the same parameters) behind
    each package's server: Score (json) and ScoreT (tensorframe, through
    ScoreClient) answer the same float32 ids from both servers, for both
    packages' clients, equal to the JAX package's dense forward (its
    runner's ``score`` through its own batcher)."""
    # one batch and one length bucket: the JAX side compiles one shape
    kw = dict(max_batch_size=4, max_delay_us=1000, batch_buckets=(4,),
              length_buckets=(8,), dtype=np.int32)
    pbatch = DynamicBatcher(T.TransformerRunner(_tparams(), TCFG,
                                                device=CPU),
                            name="t_torch_svc_score", **kw)
    rbatch = RefBatcher(R.TransformerRunner(JPARAMS, JCFG),
                        name="t_torch_svc_score_ref", **kw)
    psrv = rpc.Server()
    register_serving(psrv, batcher=pbatch)
    psrv.start("127.0.0.1", 0)
    rsrv = ref.Server(has_builtin_services=False)
    ref_register(rsrv, batcher=rbatch, http_generate_path=None)
    rsrv.start("127.0.0.1", 0)
    try:
        want = [rbatch.submit_wait(np.asarray(r, np.int32), timeout_s=120)
                for r in SCORE_ROWS]
        for port, rows in ((psrv.port, (0, 1)), (rsrv.port, (1,))):
            for mod, client_cls in ((rpc, ScoreClient),
                                    (ref, RefScoreClient)):
                ch = mod.Channel(f"127.0.0.1:{port}", timeout_ms=60_000)
                cli = client_cls(ch)
                for i in rows:
                    row, w = SCORE_ROWS[i], want[i]
                    y = cli.score(np.asarray(row, np.float32))
                    assert y.dtype == np.float32
                    np.testing.assert_array_equal(y, w)
                assert cli.wire_mode == "frame"
            js = ch.call_sync("Serving", "Score",
                              {"x": [float(t) for t in SCORE_ROWS[1]]},
                              serializer="json")
            np.testing.assert_array_equal(np.asarray(js["y"], np.float32),
                                          want[1])
        with pytest.raises(errors.RpcError) as ei:      # rank 2 refused
            rpc.Channel(f"127.0.0.1:{psrv.port}", timeout_ms=10_000
                        ).call_sync("Serving", "ScoreT",
                                    {"x": np.ones((2, 2), np.float32)},
                                    serializer="tensorframe")
        assert ei.value.code == errors.EREQUEST
    finally:
        for srv in (psrv, rsrv):
            srv.stop()
            srv.join()
        pbatch.close()
        rbatch.close()


def test_generate_through_a_supervisor_streams_the_oracle():
    """``register_serving(engine=EngineSupervisor(...))``: Generate over
    the port's server streams the JAX package's tokens, cold and warm,
    and the supervisor finishes every request."""
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16,
                             device=CPU, name="t_torch_svc_sup")

    def factory():
        runner = T.TransformerRunner(_tparams(), TCFG, store=store,
                                     device=CPU)
        return DecodeEngine(runner=runner, store=store, num_slots=2,
                            max_pages_per_slot=24, prefill_buckets=(8, 16),
                            device=CPU, name="t_torch_svc_sup")

    sup = EngineSupervisor(factory, store=store, name="t_torch_svc_sup")
    srv = rpc.Server()
    register_serving(srv, engine=sup)
    srv.start("127.0.0.1", 0)
    try:
        prompt = list(PROMPTS[1])
        cold, hit0 = _generate(rpc, srv.port, prompt, NEW)
        assert cold == jax_oracle(tuple(prompt), NEW) and hit0 == 0
        warm, hit1 = _generate(ref, srv.port, prompt, NEW)
        assert warm == cold and hit1 > 0
        assert sup.join_idle(10)
        assert sup.stats()["restarts"] == 0
    finally:
        srv.stop()
        srv.join()
        sup.close()
        store.clear()
    assert store.pagepool.blocks_leased() == 0
