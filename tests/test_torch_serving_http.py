"""Serving over the port's HTTP face, held against the JAX package.

At ``TransformerConfig()`` with the JAX package's parameters
(``params_from_jax``), on the CPU:

  * ``GET /serving/generate`` on a port server streams, as chunked JSON
    lines, exactly the tokens the JAX package's own server streams on
    the same route from its engine (and the JAX dense oracle's), cold
    and warm, read through both packages' ``HttpChannel``, with the
    native hot path on and off (the counterpart of test_serving.py's
    ``test_http_generate_progressive``);
  * a client that drops mid-stream: its emit raises EFAILEDSOCKET and
    the engine retires the slot (the terminal wraps it, as the JAX
    package's engine does), no sequence stays live;
  * ``POST /Serving/Score`` through the RESTful bridge, the handler
    deferred into the port's ``DynamicBatcher``: every row within f32
    atol 1e-4 of the JAX ``runner.score`` (through the JAX package's
    batcher), with the native hot path on and off, and the method's
    accounting on ``/status``;
  * the ``/serving`` page (the counterpart of test_serving.py's
    ``test_console_serving_page``), ``/serving/generations`` and
    ``/kvcache`` list the registered components.
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
from brpc_tpu.serving.service import register_serving as ref_register
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors, flags
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.serving import (DecodeEngine, DynamicBatcher,
                                    register_serving)

from testutil import wait_until
from test_torch_runner import (JCFG, JPARAMS, PROMPTS, TCFG, _tparams,
                               jax_oracle)

CPU = "cpu"
NEW = 3      # test_torch_runner.py's: its cached JAX oracle serves here
SCORE_ROWS = ([5, 17, 42, 9], [88, 12, 54, 61, 7, 30, 2], [3])


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    yield
    time.sleep(0.1)
    health_check.reset_all()


@pytest.fixture(params=[True, False], ids=["native", "python"])
def hot_path(request):
    flags.set_flag("native_hot_path_enabled", request.param)
    yield request.param
    flags.set_flag("native_hot_path_enabled", True)


class _Recording:
    """The engine as the HTTP route sees it: records each generation's
    terminal error."""

    def __init__(self, engine):
        self.engine, self.store = engine, engine.store
        self.terminals = []

    def submit(self, prompt, max_new, emit, on_done, **kw):
        def done(err):
            self.terminals.append(err)
            on_done(err)
        return self.engine.submit(prompt, max_new, emit, done, **kw)


@pytest.fixture(scope="module")
def port_side():
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=24,
                             device=CPU, name="t_torch_http_kv")
    free0 = store.pagepool.pool.stats()["classes"]
    runner = T.TransformerRunner(_tparams(), TCFG, store=store, device=CPU,
                                 name="t_torch_http")
    engine = DecodeEngine(runner=runner, store=store, num_slots=2,
                          max_pages_per_slot=32, prefill_buckets=(8, 16),
                          device=CPU, name="t_torch_http_eng")
    batcher = DynamicBatcher(
        T.TransformerRunner(_tparams(), TCFG, device=CPU),
        max_batch_size=4, max_delay_us=1000, batch_buckets=(4,),
        length_buckets=(8,), dtype=np.int32, name="t_torch_http_score")
    rec = _Recording(engine)
    server = rpc.Server()
    register_serving(server, batcher=batcher, engine=rec)
    server.start("127.0.0.1", 0)
    yield server, engine, store, rec
    server.stop()
    server.join()
    engine.close()
    batcher.close()
    store.clear()
    assert store.stats()["live_seqs"] == 0
    assert store.pagepool.blocks_leased() == 0
    assert store.pagepool.pool.stats()["classes"] == free0


@pytest.fixture(scope="module")
def ref_server():
    """The JAX package's server, engine and route over the same
    parameters."""
    store = R.make_store_for(JCFG, page_tokens=4, max_blocks=24,
                             name="t_torch_http_ref_kv")
    runner = R.TransformerRunner(JPARAMS, JCFG, store=store,
                                 name="t_torch_http_ref")
    eng = RefEngine(runner=runner, num_slots=2, store=store,
                    max_pages_per_slot=32, prefill_buckets=(8, 16),
                    name="t_torch_http_ref_eng")
    srv = ref.Server()
    ref_register(srv, engine=eng)
    srv.start("127.0.0.1", 0)
    yield srv
    srv.stop()
    srv.join()
    eng.close()


def http_tokens(mod, port, prompt, n, timeout=120):
    """One chunked ``/serving/generate`` read through ``mod``'s
    HttpChannel: (tokens, terminal)."""
    pieces = []
    ch = mod.HttpChannel(f"127.0.0.1:{port}")
    reader = ch.request_stream(
        "GET", f"/serving/generate?prompt={','.join(map(str, prompt))}"
               f"&max_new_tokens={n}", on_data=pieces.append)
    assert reader.wait(timeout) and reader.error is None, reader.error
    assert reader.response.headers["content-type"] == "application/json-seq"
    lines = [json.loads(x) for x in b"".join(pieces).splitlines() if x]
    ch.close()
    return [m["token"] for m in lines if "token" in m], lines[-1]


def test_http_generate_equals_the_jax_engine(port_side, ref_server,
                                             hot_path):
    server, engine, store, _ = port_side
    for prompt in PROMPTS:
        want = jax_oracle(tuple(prompt), NEW)
        theirs, t_end = http_tokens(ref, ref_server.port, prompt, NEW)
        assert theirs == want and t_end == {"done": True}
        hit0 = store.hit_tokens
        for mod in (rpc, ref):          # cold, then warm from the cache
            mine, end = http_tokens(mod, server.port, prompt, NEW)
            assert mine == theirs and end == {"done": True}
        assert store.hit_tokens > hit0
    assert engine.join_idle(30) and store.stats()["live_seqs"] == 0


def test_http_generate_bad_query_answers_400(port_side):
    server = port_side[0]
    r = rpc.HttpChannel(f"127.0.0.1:{server.port}").get(
        "/serving/generate?prompt=1,x")
    assert r.status == 400 and b"bad query" in r.body


def test_client_gone_mid_stream_retires_the_slot(port_side, hot_path):
    server, engine, store, rec = port_side
    first = threading.Event()
    ch = rpc.HttpChannel(f"127.0.0.1:{server.port}")
    n0 = len(rec.terminals)

    def on_data(data):
        if b"token" in data and not first.is_set():
            first.set()
            reader.cancel()           # the client goes away

    reader = ch.request_stream(
        "GET", "/serving/generate?prompt=5,17,42,9,77,3&max_new_tokens=100",
        on_data=on_data)
    assert first.wait(60)
    assert wait_until(lambda: len(rec.terminals) > n0, 60)
    # the emit raised EFAILEDSOCKET; the engine cancels the request
    # with it wrapped, as the JAX package's does
    err = rec.terminals[-1]
    assert err is not None and err.code == errors.EINTERNAL, err
    assert f"[E{errors.EFAILEDSOCKET}] http client gone" in err.text, err
    assert engine.join_idle(30)
    assert store.stats()["live_seqs"] == 0


@functools.cache
def jax_scores() -> list:
    """The JAX runner's ``score`` of each row, through the JAX package's
    batcher."""
    rbatch = RefBatcher(R.TransformerRunner(JPARAMS, JCFG),
                        max_batch_size=4, max_delay_us=1000,
                        batch_buckets=(4,), length_buckets=(8,),
                        dtype=np.int32, name="t_torch_http_score_ref")
    try:
        return [rbatch.submit_wait(np.asarray(r, np.int32), timeout_s=120)
                for r in SCORE_ROWS]
    finally:
        rbatch.close()


def test_restful_score_equals_jax_runner_score(port_side, hot_path):
    server = port_side[0]
    want = jax_scores()
    st = server.method_statuses[("Serving", "Score")]
    n0 = st.latency_rec.count()
    out = [None] * len(SCORE_ROWS)

    def one(i):
        ch = rpc.HttpChannel(f"127.0.0.1:{server.port}", timeout_ms=60000)
        out[i] = ch.call("Serving", "Score",
                         {"x": [float(t) for t in SCORE_ROWS[i]]})
        ch.close()

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(SCORE_ROWS))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    for got, w in zip(out, want):
        y = np.asarray(got["y"], np.float32)
        np.testing.assert_allclose(y, np.asarray(w, np.float32), atol=1e-4,
                                   rtol=0)
    assert st.latency_rec.count() == n0 + len(SCORE_ROWS)
    assert st.concurrency == 0
    # a bad body is the client's fault, not a server error
    ch = rpc.HttpChannel(f"127.0.0.1:{server.port}")
    with pytest.raises(errors.RpcError) as ei:
        ch.call("Serving", "Score", {"nope": 1})
    assert ei.value.code == errors.EREQUEST
    ch.close()


def test_console_serving_pages(port_side):
    server = port_side[0]
    http_tokens(rpc, server.port, PROMPTS[0], 2)
    ch = rpc.HttpChannel(f"127.0.0.1:{server.port}")
    snap = ch.get("/serving").json()
    assert "t_torch_http_score" in snap["batchers"]
    st = snap["engines"]["t_torch_http_eng"]
    assert st["num_slots"] == 2 and len(st["slots"]) == 2
    b = snap["batchers"]["t_torch_http_score"]
    assert "shed" in b and "pad_waste_ratio" in b
    gens = ch.get("/serving/generations").json()
    assert gens["aggregates"]["ttft_us"]["count"] >= 1
    assert any(r.get("engine") == "t_torch_http_eng"
               for r in gens["recent"])
    kv = ch.get("/kvcache").json()
    assert "t_torch_http_kv" in kv["stores"]
    ch.close()
