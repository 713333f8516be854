"""rpc_press's fleet modes (a copy of those parts of
``brpc_tpu/tools/rpc_press.py``): spin up N in-process serving replicas
behind a :class:`~brpc_tpu_torch.serving.ClusterRouter` and press full
generations through the front door, or one fleet carrying every traffic
shape at once.

  python -m brpc_tpu_torch.tools.rpc_press --cluster 2 --device cpu \\
      --input '{"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 8}' \\
      --duration 5 --threads 4

Each replica is a harness-mode paged KV store, a decode engine over the
plain numpy step function and a server with the ``Serving``, ``_kvmig``,
``_cluster`` and ``_telemetry`` services, as the reference's are; its
store lives on ``device`` (default ``cuda``).  The report is one JSON
line: generations/s, tokens/s, time-to-first-token percentiles, the
resume count (replica failovers ridden by sessions) and the overload
gradient's per-level fire counts.  ``--kill-replica-after S`` kills one
replica S seconds in, so sessions resume under load; ``--slo`` attaches
an observe-only SLO engine and reports its verdict and burns.

  --cluster N --models a,b        named model deployments on every
                                  replica (each model its own step rule,
                                  ``MODEL_STEP_PRIMES``), workers
                                  alternating models; per-model
                                  generations/s and TTFT, and the
                                  wrong-model-route count (must be 0)
  --cluster N --kill-router-after S
                                  the router as its own process over a
                                  session WAL, SIGKILLed S seconds in; a
                                  successor adopts the WAL and every
                                  session in flight resumes from its
                                  client's cursor
  --mixed lookup,generate,train   one fleet (PS shards, a replica, a
                                  trainer) serving the shapes at once
                                  under the ``TrafficArbiter``; per-shape
                                  qps and p99 and the ladder's fire
                                  counts, cheapest rung first
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from .. import errors, rpc
from ..bvar import LatencyRecorder


def spin_up_cluster(n_replicas: int, *, page_tokens: int = 8,
                    step_delay_s: float = 0.0, num_slots: int = 8,
                    max_blocks: int = 64, page_bytes: int = 512,
                    max_pages_per_slot: int = 64,
                    name_prefix: str = "cluster",
                    commit_live_pages: bool = False,
                    replicate_sessions: bool = False,
                    max_sessions: int = 256,
                    timeout_ms: int = 20_000, device=None):
    """Build an in-process cluster: :func:`spin_up_replicas` behind a
    :class:`~brpc_tpu_torch.serving.ClusterRouter` on its own router
    server.  Returns ``(replicas, router, rsrv, raddr)`` with
    ``replicas`` a list of ``(store, engine, server, addr)``; tear down
    with :func:`tear_down_cluster`."""
    from ..serving import ClusterRouter, ReplicaHandle, register_router

    replicas = spin_up_replicas(
        n_replicas, page_tokens=page_tokens, step_delay_s=step_delay_s,
        num_slots=num_slots, max_blocks=max_blocks,
        page_bytes=page_bytes, max_pages_per_slot=max_pages_per_slot,
        name_prefix=name_prefix, commit_live_pages=commit_live_pages,
        device=device)
    router = ClusterRouter(
        [ReplicaHandle(addr, name=f"{name_prefix}_{i}", engine=eng,
                       store=store, server=srv)
         for i, (store, eng, srv, addr) in enumerate(replicas)],
        page_tokens=page_tokens, replicate_sessions=replicate_sessions,
        max_sessions=max_sessions, name=f"{name_prefix}_router",
        timeout_ms=timeout_ms)
    rsrv = rpc.Server()
    register_router(rsrv, router)
    rsrv.start("127.0.0.1", 0)
    return replicas, router, rsrv, f"127.0.0.1:{rsrv.port}"


def spin_up_replicas(n_replicas: int, *, page_tokens: int = 8,
                     step_delay_s: float = 0.0, num_slots: int = 8,
                     max_blocks: int = 64, page_bytes: int = 512,
                     max_pages_per_slot: int = 64,
                     name_prefix: str = "cluster",
                     commit_live_pages: bool = False, device=None):
    """N serving replicas (a harness-mode paged KV store on ``device`` and
    a decode engine over the numpy step function ``(t * 7 + pos) %
    997``, each step optionally sleeping ``step_delay_s``), each exposing
    ``Serving``, ``_kvmig``, ``_cluster`` and ``_telemetry``: they work
    behind an in-process router or an address-only one in another
    process.  Returns a list of ``(store, engine, server, addr)``; tear
    down with :func:`tear_down_replicas`."""
    import numpy as np

    from ..device import resolve_device
    from ..ici.block_pool import BlockPool
    from ..kvcache import KVCacheStore
    from ..migrate import make_prefix_fetcher, register_migration
    from ..serving import (DecodeEngine, register_cluster_control,
                           register_serving, register_telemetry)

    device = resolve_device(device)

    def step(tokens, positions, pages=None):
        if step_delay_s:
            time.sleep(step_delay_s)
        return (np.asarray(tokens) * 7 + np.asarray(positions)) % 997

    replicas = []
    for i in range(n_replicas):
        # a block pool each: the replicas live side by side
        store = KVCacheStore(BlockPool(device), page_tokens=page_tokens,
                             page_bytes=page_bytes, max_blocks=max_blocks,
                             name=f"{name_prefix}_{i}",
                             commit_live_pages=commit_live_pages,
                             vector_kv=False)
        eng = DecodeEngine(step, num_slots=num_slots, store=store,
                           max_pages_per_slot=max_pages_per_slot,
                           device=device,
                           name=f"{name_prefix}_eng_{i}")
        srv = rpc.Server(enable_dcn=True, dcn_device=str(device))
        serving_svc = register_serving(srv, engine=eng)
        mig_svc = register_migration(srv, store)
        register_cluster_control(srv, engine=eng, store=store,
                                 name=f"{name_prefix}_{i}")
        register_telemetry(srv, name=f"{name_prefix}_{i}")
        srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{srv.port}"
        # the fetcher needs the replica's own addr, known only now
        serving_svc.prefix_fetcher = make_prefix_fetcher(
            mig_svc.migrator, addr)
        replicas.append((store, eng, srv, addr))
    return replicas


def tear_down_replicas(replicas) -> None:
    """Close what :func:`spin_up_replicas` built (replicas already
    killed mid-run tear down quietly)."""
    for store, eng, srv, _addr in replicas:
        try:
            eng.close(timeout_s=2.0)
        except Exception:
            pass
        try:
            srv.stop()
            srv.join()
        except Exception:
            pass
        store.clear()
        store.close()


def tear_down_cluster(replicas, router, rsrv,
                      timeout_s: float = 3.0) -> None:
    """Close everything :func:`spin_up_cluster` built."""
    router.close(timeout_s=timeout_s)
    rsrv.stop()
    rsrv.join()
    tear_down_replicas(replicas)


# ---------------------------------------------------------------------------
# multi-model fleets
# ---------------------------------------------------------------------------

# per-model step multipliers: model i's decode rule is (t * PRIME_i + pos)
# % 997, so each model's stream differs from every other's and a stream
# equal to the WRONG model's oracle is a mis-route, caught by the client
MODEL_STEP_PRIMES = (7, 11, 13, 17, 19, 23, 29)


def model_step_fn(mult: int, step_delay_s=0.0):
    """The numpy step function of one model deployment.
    ``step_delay_s`` is a float or a zero-argument callable read each
    step: the knob that makes ONE version's inter-token latency burn
    while its tokens stay bit-exact."""
    import numpy as np

    def step(tokens, positions, pages=None):
        d = step_delay_s() if callable(step_delay_s) else step_delay_s
        if d:
            time.sleep(d)
        return (np.asarray(tokens) * int(mult)
                + np.asarray(positions)) % 997

    return step


def expected_model_tokens(prompt, n: int, mult: int = 7) -> list:
    """The oracle of :func:`model_step_fn`: the n tokens a correct
    generation of ``prompt`` emits under multiplier ``mult``."""
    out = []
    last = int(prompt[-1])
    pos = len(prompt)
    for _ in range(int(n)):
        last = (last * int(mult) + pos) % 997
        out.append(last)
        pos += 1
    return out


def spin_up_multimodel_replicas(n_replicas: int, models, *, layout=None,
                                page_tokens: int = 8,
                                step_delay_s=0.0,
                                num_slots: int = 8, max_blocks: int = 64,
                                page_bytes: int = 512,
                                max_pages_per_slot: int = 64,
                                name_prefix: str = "mm",
                                commit_live_pages: bool = False,
                                warm: bool = True, device=None):
    """N serving replicas, each with one :class:`~brpc_tpu_torch.serving.
    ReplicaDeployments` table over ``models``: a harness-mode store on
    its own block pool on ``device`` and an engine per deployment (model
    i's step rule uses ``MODEL_STEP_PRIMES[i]``, so streams name their
    model), ``Serving`` resolving the forwarded ``model`` field,
    ``_cluster`` publishing the catalog, ``_telemetry``, and ``_kvmig``
    bound to the FIRST deployment's store and tagged with its model (a
    fetch for another model is refused; other models recompute).

    ``layout[i]`` restricts replica i to a subset of ``models`` (default:
    every replica serves all of them); ``step_delay_s`` is a float, a
    callable, or a dict keyed by deployment key (a per-version delay);
    ``warm=False`` starts deployments ``loading`` (their first finished
    generation flips them warm).

    Returns ``(replicas, mults)``: dicts with keys ``deps``, ``stores``,
    ``engines``, ``server``, ``addr``, ``models`` and ``serving``, and
    the ``model -> multiplier`` oracle map.  Tear down with
    :func:`tear_down_multimodel_replicas`."""
    from ..device import resolve_device
    from ..ici.block_pool import BlockPool
    from ..kvcache import KVCacheStore
    from ..migrate import make_prefix_fetcher, register_migration
    from ..serving import (DecodeEngine, ReplicaDeployments,
                           register_cluster_control, register_serving,
                           register_telemetry)
    from ..serving.modelplane import LOADING, WARM

    device = resolve_device(device)
    models = [str(m) for m in models]
    mults = {m: MODEL_STEP_PRIMES[i % len(MODEL_STEP_PRIMES)]
             for i, m in enumerate(models)}
    state0 = WARM if warm else LOADING
    replicas = []
    try:
        for i in range(n_replicas):
            served = models if layout is None \
                else [str(m) for m in layout[i]]
            deps = ReplicaDeployments(name=f"{name_prefix}_{i}")
            r = {"deps": deps, "stores": {}, "engines": {}, "server": None,
                 "addr": None, "models": list(served), "serving": None}
            replicas.append(r)
            for m in served:
                store = KVCacheStore(
                    BlockPool(device), page_tokens=page_tokens,
                    page_bytes=page_bytes, max_blocks=max_blocks,
                    name=f"{name_prefix}_{i}_{m}",
                    commit_live_pages=commit_live_pages, vector_kv=False)
                r["stores"][m] = store
                delay = step_delay_s.get(m, 0.0) \
                    if isinstance(step_delay_s, dict) else step_delay_s
                eng = DecodeEngine(model_step_fn(mults[m], delay),
                                   num_slots=num_slots, store=store,
                                   max_pages_per_slot=max_pages_per_slot,
                                   device=device,
                                   name=f"{name_prefix}_eng_{i}_{m}")
                r["engines"][m] = eng
                deps.deploy(m, engine=eng, store=store, state=state0)
            m0 = served[0] if served else None
            srv = rpc.Server(enable_dcn=True, dcn_device=str(device))
            r["server"] = srv
            r["serving"] = register_serving(
                srv, engine=r["engines"].get(m0), deployments=deps)
            mig = register_migration(srv, r["stores"][m0], model=m0) \
                if m0 else None
            register_cluster_control(srv, engine=r["engines"].get(m0),
                                     store=r["stores"].get(m0),
                                     name=f"{name_prefix}_{i}",
                                     deployments=deps)
            register_telemetry(srv, name=f"{name_prefix}_{i}")
            srv.start("127.0.0.1", 0)
            r["addr"] = f"127.0.0.1:{srv.port}"
            if mig is not None:
                # a fetcher on the _kvmig-bound deployment only: one
                # shared by all would splice other models' fetches into
                # m0's store
                deps.deploy(m0, prefix_fetcher=make_prefix_fetcher(
                    mig.migrator, r["addr"], model=m0), state=state0)
    except BaseException:
        tear_down_multimodel_replicas(replicas)
        raise
    return replicas, mults


def tear_down_multimodel_replicas(replicas) -> None:
    """Close what :func:`spin_up_multimodel_replicas` built."""
    for r in replicas:
        for eng in r["engines"].values():
            try:
                eng.close(timeout_s=2.0)
            except Exception:
                pass
        if r["server"] is not None:
            try:
                r["server"].stop()
                r["server"].join()
            except Exception:
                pass
        for store in r["stores"].values():
            store.clear()
            store.close()


def spin_up_multimodel_cluster(n_replicas: int, models, *, layout=None,
                               page_tokens: int = 8,
                               step_delay_s=0.0,
                               commit_live_pages: bool = False,
                               replicate_sessions: bool = False,
                               max_sessions: int = 256,
                               timeout_ms: int = 20_000,
                               name_prefix: str = "mm", warm: bool = True,
                               wal=None, router_kw=None, device=None,
                               **replica_kw):
    """A multi-model fleet behind one :class:`~brpc_tpu_torch.serving.
    ClusterRouter`: :func:`spin_up_multimodel_replicas` and a router
    whose handles carry the deployment tables (the catalog is seeded at
    once; the replicas' publications keep it fresh).  Returns
    ``(replicas, mults, router, rsrv, raddr)``; tear down with
    :func:`tear_down_multimodel_cluster`."""
    from ..serving import ClusterRouter, ReplicaHandle, register_router

    replicas, mults = spin_up_multimodel_replicas(
        n_replicas, models, layout=layout, page_tokens=page_tokens,
        step_delay_s=step_delay_s, commit_live_pages=commit_live_pages,
        name_prefix=name_prefix, warm=warm, device=device, **replica_kw)
    handles = []
    for i, r in enumerate(replicas):
        m0 = r["models"][0] if r["models"] else None
        handles.append(ReplicaHandle(
            r["addr"], name=f"{name_prefix}_{i}",
            engine=r["engines"].get(m0), store=r["stores"].get(m0),
            server=r["server"], deployments=r["deps"]))
    kw = dict(router_kw or {})
    if wal is not None:
        kw["wal"] = wal
    router = rsrv = None
    try:
        router = ClusterRouter(
            handles, page_tokens=page_tokens,
            replicate_sessions=replicate_sessions,
            max_sessions=max_sessions, name=f"{name_prefix}_router",
            timeout_ms=timeout_ms, **kw)
        rsrv = rpc.Server()
        register_router(rsrv, router)
        rsrv.start("127.0.0.1", 0)
    except BaseException:
        if router is not None:
            router.close()
        tear_down_multimodel_replicas(replicas)
        raise
    return replicas, mults, router, rsrv, f"127.0.0.1:{rsrv.port}"


def tear_down_multimodel_cluster(replicas, router, rsrv,
                                 timeout_s: float = 3.0) -> None:
    """Close everything :func:`spin_up_multimodel_cluster` built."""
    router.close(timeout_s=timeout_s)
    rsrv.stop()
    rsrv.join()
    tear_down_multimodel_replicas(replicas)


def zipf_key_sampler(vocab: int, s: float, seed: int = 0):
    """A seeded zipf-skewed key sampler: key k's probability is
    proportional to 1/(rank+1)^s under a seeded permutation (so hot keys
    spread across shard ranges).  s=0 is uniform."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(vocab)
    p = 1.0 / np.power(np.arange(vocab, dtype=np.float64) + 1.0,
                       max(float(s), 0.0))
    p /= p.sum()
    probs = np.empty(vocab)
    probs[ranks] = p

    def sample(n: int) -> np.ndarray:
        return rng.choice(vocab, size=n, p=probs).astype(np.int64)

    return sample


def run_cluster_press(n_replicas: int, request,
                      duration_s: float = 10.0, threads: int = 4,
                      timeout_ms: int = 20_000, request_factory=None,
                      kill_replica_after: float | None = None,
                      slo: bool = False, device=None,
                      out=sys.stderr) -> dict:
    """``--cluster N`` mode (see the module docstring).  ``request`` is
    ``{"prompt": [...], "max_new_tokens": n}``; ``request_factory(k)``,
    if given, returns worker k's per-call request generator instead.
    ``slo`` attaches an observe-only SLO engine to the router (a
    one-model press has no canary pair to re-weight: its verdicts
    report and never act) and adds its verdict and burns to the
    report."""
    from ..serving import RouterClient

    replicas, router, rsrv, raddr = spin_up_cluster(
        n_replicas, page_tokens=8, commit_live_pages=True,
        replicate_sessions=True, max_sessions=max(64, 8 * threads),
        name_prefix="press_cl", timeout_ms=timeout_ms, device=device)
    if slo:
        from ..serving import Objective, SLOEngine
        from ..serving.modelplane import DEFAULT_MODEL
        router.attach_slo(SLOEngine(
            DEFAULT_MODEL, DEFAULT_MODEL, DEFAULT_MODEL,
            [Objective("ttft_p99_ms", 500.0),
             Objective("itl_p99_ms", 50.0),
             Objective("error_rate", 0.05)],
            short_window_s=1.0, long_window_s=3.0, act=False))
    # unexposed: nothing keeps it (and its native slot) past the run
    rec_ttft = LatencyRecorder()
    try:
        mu = threading.Lock()
        gens_ok = [0]
        nerr = [0]
        nshed = [0]
        tokens = [0]
        stop = threading.Event()

        def worker(k: int):
            cli = RouterClient(raddr, timeout_ms=timeout_ms)
            gen = request_factory(k) if request_factory is not None \
                else None
            while not stop.is_set():
                req = gen() if gen is not None else request
                prompt = req.get("prompt") or [1]
                n = int(req.get("max_new_tokens", 16))
                first = [None]

                def emit(tok, first=first):
                    if first[0] is None:
                        first[0] = time.monotonic()

                t0 = time.monotonic()
                try:
                    res = cli.generate(prompt, n, emit=emit,
                                       timeout_s=timeout_ms / 1e3)
                except errors.RpcError as e:
                    with mu:
                        if e.code == errors.ELIMIT:
                            nshed[0] += 1   # shed at the router, by design
                        else:
                            nerr[0] += 1
                    continue
                except Exception:
                    with mu:
                        nerr[0] += 1
                    continue
                with mu:
                    if res["error"]:
                        nerr[0] += 1
                        continue
                    gens_ok[0] += 1
                    tokens[0] += len(res["tokens"])
                if first[0] is not None:
                    rec_ttft.add(int((first[0] - t0) * 1e6))

        ts = [threading.Thread(target=worker, args=(k,), daemon=True)
              for k in range(threads)]
        t_start = time.monotonic()
        for t in ts:
            t.start()
        try:
            if kill_replica_after is not None and \
                    kill_replica_after < duration_s:
                time.sleep(kill_replica_after)
                _store, keng, ksrv, kaddr = replicas[0]
                print(f"cluster press: killing replica {kaddr}",
                      file=sys.stderr)
                ksrv.stop()
                ksrv.join()
                keng.close(timeout_s=2.0)
                time.sleep(max(0.0, duration_s - kill_replica_after))
            else:
                time.sleep(duration_s)
        finally:
            stop.set()
        for t in ts:
            t.join(timeout_ms / 1e3 + 2)
        elapsed = time.monotonic() - t_start
        rstats = router.stats()
        summary = {
            "replicas": n_replicas,
            "generations_ok": gens_ok[0],
            "errors": nerr[0],
            "client_sheds": nshed[0],
            "tokens": tokens[0],
            "generations_per_s": round(gens_ok[0] / elapsed, 1),
            "tokens_per_s": round(tokens[0] / elapsed, 1),
            "ttft_avg_us": round(rec_ttft.latency(), 1),
            "ttft_p50_us": rec_ttft.latency_percentile(0.5),
            "ttft_p90_us": rec_ttft.latency_percentile(0.9),
            "ttft_p99_us": rec_ttft.latency_percentile(0.99),
            "resumes": rstats["resumes"],
            "shed_counts": rstats["gradient_fired"],
            "router_level": rstats["ladder"]["level"],
            "elapsed_s": round(elapsed, 2),
        }
        tel = rstats.get("telemetry") or {}
        summary["telemetry"] = {k: tel.get(k, 0) for k in
                                ("pulls", "pull_bytes", "pull_errors",
                                 "tombstones")}
        if slo and rstats.get("slo"):
            summary["slo"] = _slo_summary(rstats["slo"])
        print(json.dumps(summary), file=out)
    finally:
        tear_down_cluster(replicas, router, rsrv)
    return summary


def _slo_summary(s: dict) -> dict:
    """The observe-only SLO block of a press report (also printed to
    stderr): the canary side's verdict and burns, the floor, the
    evaluations."""
    can = (s.get("last_eval") or {}).get("canary") or {}
    print("--- slo (observe-only burn rates) ---", file=sys.stderr)
    print(f"verdict={can.get('verdict')} floor={s.get('floor')} "
          f"evaluations={s.get('evaluations')}", file=sys.stderr)
    for met, b in sorted((can.get("burns") or {}).items()):
        print(f"  {met}: target={b.get('target')} "
              f"burn_short={b.get('short')} burn_long={b.get('long')}"
              + (" BURNING" if b.get("burning") else ""), file=sys.stderr)
    return {"verdict": can.get("verdict"), "burns": can.get("burns"),
            "floor": s.get("floor"), "evaluations": s.get("evaluations")}


def run_multimodel_press(n_replicas: int, models,
                         duration_s: float = 10.0, threads: int = 4,
                         max_new_tokens: int = 12,
                         timeout_ms: int = 20_000, device=None,
                         out=sys.stderr) -> dict:
    """``--cluster N --models a,b[,c]`` mode: a multi-model fleet behind
    one router, workers alternating models per request.  Every finished
    stream is held to ITS model's oracle; one that equals ANOTHER
    model's oracle is a wrong-model route.  The report has per-model
    generations/s and TTFT percentiles, and the wrong-model-route count
    from three witnesses (the clients' oracles, the router's
    ``wrong_model_routes``, the replicas' ``n_model_misroutes``), which
    must be 0."""
    import random

    from ..serving import RouterClient

    models = [str(m) for m in models]
    replicas, mults, router, rsrv, raddr = spin_up_multimodel_cluster(
        n_replicas, models, commit_live_pages=True,
        replicate_sessions=True, max_sessions=max(64, 8 * threads),
        name_prefix="press_mm", timeout_ms=timeout_ms, device=device)
    try:
        mu = threading.Lock()
        # unexposed recorders: nothing keeps them past the run
        per = {m: {"ok": 0, "err": 0, "sheds": 0, "tokens": 0,
                   "mismatches": 0, "rec": LatencyRecorder()}
               for m in models}
        wrong_route = [0]
        stop = threading.Event()

        def worker(k: int):
            cli = RouterClient(raddr, timeout_ms=timeout_ms)
            rng = random.Random(1000 + k)
            j = 0
            while not stop.is_set():
                m = models[(k + j) % len(models)]
                j += 1
                st = per[m]
                prompt = [rng.randrange(1, 97)]
                first = [None]

                def emit(tok, first=first):
                    if first[0] is None:
                        first[0] = time.monotonic()

                t0 = time.monotonic()
                try:
                    res = cli.generate(prompt, max_new_tokens, emit=emit,
                                       timeout_s=timeout_ms / 1e3, model=m)
                except errors.RpcError as e:
                    with mu:
                        if e.code == errors.ELIMIT:
                            st["sheds"] += 1
                        else:
                            st["err"] += 1
                    continue
                except Exception:
                    with mu:
                        st["err"] += 1
                    continue
                with mu:
                    if res["error"]:
                        st["err"] += 1
                        continue
                    st["ok"] += 1
                    got = res["tokens"]
                    st["tokens"] += len(got)
                    if got != expected_model_tokens(prompt, len(got),
                                                    mults[m]):
                        st["mismatches"] += 1
                        if any(got == expected_model_tokens(
                                prompt, len(got), mm)
                               for mo, mm in mults.items() if mo != m):
                            wrong_route[0] += 1
                if first[0] is not None:
                    st["rec"].add(int((first[0] - t0) * 1e6))

        ts = [threading.Thread(target=worker, args=(k,), daemon=True)
              for k in range(threads)]
        t_start = time.monotonic()
        for t in ts:
            t.start()
        try:
            time.sleep(duration_s)
        finally:
            stop.set()
        for t in ts:
            t.join(timeout_ms / 1e3 + 2)
        elapsed = time.monotonic() - t_start
        rstats = router.stats()
        misroutes = sum(r["serving"].n_model_misroutes for r in replicas)
        summary = {
            "replicas": n_replicas,
            "models": {},
            "wrong_model_routes": (wrong_route[0]
                                   + int(rstats["wrong_model_routes"])
                                   + misroutes),
            "elapsed_s": round(elapsed, 2),
        }
        for m in models:
            st = per[m]
            rec = st["rec"]
            summary["models"][m] = {
                "generations_ok": st["ok"],
                "errors": st["err"],
                "client_sheds": st["sheds"],
                "mismatches": st["mismatches"],
                "generations_per_s": round(st["ok"] / elapsed, 1),
                "tokens_per_s": round(st["tokens"] / elapsed, 1),
                "ttft_p50_us": rec.latency_percentile(0.5),
                "ttft_p90_us": rec.latency_percentile(0.9),
                "ttft_p99_us": rec.latency_percentile(0.99),
            }
        print(json.dumps(summary), file=out)
    finally:
        tear_down_multimodel_cluster(replicas, router, rsrv)
    return summary


def run_router_kill_press(n_replicas: int, request,
                          duration_s: float = 10.0, threads: int = 4,
                          kill_router_after: float = 3.0,
                          timeout_ms: int = 20_000,
                          request_factory=None, device=None,
                          out=sys.stderr) -> dict:
    """``--cluster N --kill-router-after S`` mode: the replicas stay in
    this process, the ROUTER runs as its own process over a session WAL.
    S seconds in, it is SIGKILLed and a successor is spawned over the
    same WAL file; every generation in flight resumes against the
    successor from its client-held cursor.  The report adds the resume
    count and the resume latency's percentiles (client resume call ->
    generation complete) to the usual press numbers."""
    import os
    import shutil
    import tempfile

    from ..serving import RouterClient
    from ..serving.router_proc import spawn_router

    replicas = spin_up_replicas(
        n_replicas, page_tokens=8, commit_live_pages=True,
        step_delay_s=0.002, name_prefix="press_kr", device=device)
    addrs = [addr for _, _, _, addr in replicas]
    wal_dir = tempfile.mkdtemp(prefix="rpc_press_wal_")
    wal_path = os.path.join(wal_dir, "sessions.wal")
    rkw = dict(replicate_sessions=True, replication_factor=2,
               page_tokens=8, max_sessions=max(64, 8 * threads),
               timeout_ms=timeout_ms)
    procs = []
    try:
        proc, raddr = spawn_router(wal_path, addrs, **rkw)
        procs.append(proc)
        # unexposed recorders: nothing keeps them past the run
        rec_ttft = LatencyRecorder()
        rec_resume = LatencyRecorder()
        mu = threading.Lock()
        gens_ok = [0]
        nerr = [0]
        nshed = [0]
        tokens = [0]
        resumes = [0]
        stop = threading.Event()
        router_up = threading.Event()
        router_up.set()
        cur_addr = [raddr]

        def worker(k: int):
            gen_req = request_factory(k) if request_factory is not None \
                else None
            while not stop.is_set():
                router_up.wait(1.0)
                if stop.is_set():
                    return
                cli = RouterClient(cur_addr[0], timeout_ms=timeout_ms,
                                   shed_retries=0)
                req = gen_req() if gen_req is not None else request
                prompt = req.get("prompt") or [1]
                n = int(req.get("max_new_tokens", 16))
                first = [None]

                def emit(tok, first=first):
                    if first[0] is None:
                        first[0] = time.monotonic()

                t0 = time.monotonic()
                try:
                    live = cli.start(prompt, n, emit=emit)
                except errors.RpcError as e:
                    with mu:
                        if e.code == errors.ELIMIT:
                            nshed[0] += 1
                        else:
                            nerr[0] += 1
                    continue
                except Exception:
                    with mu:
                        nerr[0] += 1
                    continue
                done = live.wait(timeout_ms / 1e3)
                if done and live.error is None:
                    with mu:
                        gens_ok[0] += 1
                        tokens[0] += len(live.tokens)
                    if first[0] is not None:
                        rec_ttft.add(int((first[0] - t0) * 1e6))
                    continue
                # the router died (or wedged) mid-flight: resume the
                # SESSION on whichever router holds the WAL now, from
                # the client-held cursor
                sid, cursor = live.session_id, live.cursor
                try:
                    live.drop()
                except Exception:
                    pass
                if not sid or stop.is_set():
                    with mu:
                        nerr[0] += 1
                    continue
                router_up.wait(timeout_ms / 1e3)
                r0 = time.monotonic()
                try:
                    res = RouterClient(
                        cur_addr[0], timeout_ms=timeout_ms,
                        shed_retries=0).resume_wait(
                            sid, cursor, timeout_s=timeout_ms / 1e3)
                except Exception:
                    with mu:
                        nerr[0] += 1
                    continue
                rec_resume.add(int((time.monotonic() - r0) * 1e6))
                with mu:
                    resumes[0] += 1
                    if res["error"]:
                        nerr[0] += 1
                    else:
                        gens_ok[0] += 1
                        tokens[0] += len(res["tokens"]) + cursor

        ts = [threading.Thread(target=worker, args=(k,), daemon=True)
              for k in range(threads)]
        t_start = time.monotonic()
        for t in ts:
            t.start()
        adoption_ms = None
        try:
            time.sleep(min(kill_router_after, duration_s))
            print(f"cluster press: SIGKILL router pid={proc.pid}",
                  file=sys.stderr)
            router_up.clear()
            k0 = time.monotonic()
            proc.kill()
            proc.wait()
            proc, raddr2 = spawn_router(wal_path, addrs, **rkw)
            procs.append(proc)
            adoption_ms = round((time.monotonic() - k0) * 1e3, 1)
            cur_addr[0] = raddr2
            router_up.set()
            time.sleep(max(0.0, duration_s - kill_router_after))
        finally:
            stop.set()
            router_up.set()
        for t in ts:
            t.join(timeout_ms / 1e3 + 2)
        elapsed = time.monotonic() - t_start
        try:
            replay = rpc.Channel(cur_addr[0], timeout_ms=5000).call_sync(
                "Router", "Stats", {}, serializer="json",
                response_serializer="json").get("wal_replay")
        except Exception:
            replay = None
        summary = {
            "replicas": n_replicas,
            "generations_ok": gens_ok[0],
            "errors": nerr[0],
            "client_sheds": nshed[0],
            "tokens": tokens[0],
            "generations_per_s": round(gens_ok[0] / elapsed, 1),
            "tokens_per_s": round(tokens[0] / elapsed, 1),
            "ttft_avg_us": round(rec_ttft.latency(), 1),
            "ttft_p50_us": rec_ttft.latency_percentile(0.5),
            "ttft_p99_us": rec_ttft.latency_percentile(0.99),
            "router_resumes": resumes[0],
            "resume_p50_us": rec_resume.latency_percentile(0.5),
            "resume_p90_us": rec_resume.latency_percentile(0.9),
            "resume_p99_us": rec_resume.latency_percentile(0.99),
            "router_adoption_ms": adoption_ms,
            "wal_replay": replay,
            "elapsed_s": round(elapsed, 2),
        }
        print(json.dumps(summary), file=out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        tear_down_replicas(replicas)
        shutil.rmtree(wal_dir, ignore_errors=True)
    return summary


def run_mixed_press(shapes, *, weights=None, n_shards: int = 2,
                    vocab: int = 128, dim: int = 16,
                    gen_tokens: int = 16, train_steps: int = 8,
                    duration_s: float = 10.0, seed: int = 0, device=None,
                    out=sys.stderr) -> dict:
    """``--mixed lookup,generate,train``: ONE in-process fleet serving
    every requested traffic shape at once -- zipf PS lookups, streamed
    generations, trainer update waves -- with the
    :class:`~brpc_tpu_torch.train.TrafficArbiter` arbitrating across
    them.  ``weights`` scales the worker counts per shape (in the shape
    list's order; default 1 each).  The report prints per-shape qps and
    latency percentiles and the arbiter ladder's fire counters, so the
    cheapest-first order (trainer paced or shed before any serving rung)
    shows on the command line."""
    from ..train.arbiter import MixedWorkloadHarness
    shapes = [s.strip() for s in shapes if s.strip()]
    known = ("lookup", "generate", "train")
    bad = [s for s in shapes if s not in known]
    if bad:
        raise ValueError(f"unknown shapes {bad}; pick from {known}")
    if not shapes:
        raise ValueError("--mixed needs at least one shape")
    w = {s: 1 for s in shapes}
    for s, n in zip(shapes, weights or []):
        w[s] = int(n)
    h = MixedWorkloadHarness(
        n_shards=n_shards, vocab=vocab, dim=dim,
        lookup_workers=w.get("lookup", 0),
        gen_workers=w.get("generate", 0), gen_tokens=gen_tokens,
        train_workers=w.get("train", 0),
        train_steps=train_steps if "train" in w else 0,
        min_duration_s=duration_s, seed=seed, name="mixed_press",
        device=device)
    try:
        rep = h.run()
    finally:
        h.close()

    def ms(v):
        return "-" if v is None else f"{v / 1000.0:.2f}ms"

    print(f"--- mixed press: {'+'.join(shapes)} over {n_shards} PS "
          f"shards, {rep['elapsed_s']:.1f}s ---", file=out)
    for name in ("lookup", "generate"):
        st = rep["shapes"][name]
        if not (st["ok"] or st["err"]):
            continue
        extra = (f"  bit_exact={st['bit_exact']}/{st['ok']}"
                 if name == "generate" else "")
        print(f"{name:>9}: {st['qps']:8.1f} qps  "
              f"p50 {ms(st['p50_us'])}  p99 {ms(st['p99_us'])}  "
              f"errors {st['err']}{extra}", file=out)
    tr = rep["train"]
    if tr["waves"]:
        print(f"{'train':>9}: {tr['updates_per_s']:8.1f} waves/s  "
              f"waves {tr['waves']}  retries {tr['wave_retries']}  "
              f"paced {tr['paced_waves']}  "
              f"loss {tr['loss_first']:.4f} -> {tr['loss_final']:.4f}",
              file=out)
    lad = rep["arbiter"]["ladder"]
    print("ladder fire counts (cheapest first):", file=out)
    for i, name in enumerate(lad["level_names"]):
        print(f"  L{i + 1} {name:<18} escalations "
              f"{lad['escalations'][i]:<4} first_fired "
              f"{lad['first_fired'][i]}", file=out)
    print(f"arbiter: admitted {rep['arbiter']['admitted_waves']}  "
          f"paced {rep['arbiter']['paced_waves']}  "
          f"shed {rep['arbiter']['shed_waves']}", file=out)
    print(f"invariants: exactly_once={all(rep['exactly_once'])}  "
          f"stale_reads={rep['stale_reads']}  "
          f"queues_drained={rep['queues_drained']}  "
          f"pools_at_baseline={rep['pools_at_baseline']}", file=out)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="spin up N in-process serving replicas behind "
                         "a ClusterRouter and press generations "
                         "through the front door")
    ap.add_argument("--models", metavar="A,B[,C]",
                    help="with --cluster: serve these named model "
                         "deployments on every replica and press them "
                         "through one router; reports per-model "
                         "generations/s, TTFT percentiles and the "
                         "wrong-model-route count (must be 0)")
    ap.add_argument("--kill-replica-after", type=float, default=None,
                    metavar="S",
                    help="with --cluster: kill one replica S seconds "
                         "into the run so session resume runs under "
                         "load")
    ap.add_argument("--slo", action="store_true",
                    help="with --cluster: attach an observe-only SLO "
                         "burn-rate engine to the router and report its "
                         "verdict and burns")
    ap.add_argument("--kill-router-after", type=float, default=None,
                    metavar="S",
                    help="with --cluster: run the router as its own "
                         "process over a session WAL, SIGKILL it S "
                         "seconds in, spawn a successor over the same "
                         "WAL and resume every session in flight")
    ap.add_argument("--mixed", metavar="SHAPES",
                    help="comma list from lookup,generate,train: one "
                         "in-process fleet serving every shape at once, "
                         "the TrafficArbiter arbitrating; reports "
                         "per-shape qps and p99 and the ladder's fire "
                         "counts")
    ap.add_argument("--mixed-weights", metavar="W",
                    help="with --mixed: comma worker weights in the "
                         "order of --mixed (default 1 each)")
    ap.add_argument("--shards", type=int, default=2,
                    help="with --mixed: PS shard count")
    ap.add_argument("--train-steps", type=int, default=8,
                    help="with --mixed: trainer steps per worker")
    ap.add_argument("--vocab", type=int, default=1024,
                    help="with --mixed: embedding table rows")
    ap.add_argument("--dim", type=int, default=32,
                    help="with --mixed: embedding row width")
    ap.add_argument("--input", default="{}",
                    help="JSON request body, or @file.json")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--timeout-ms", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="where the replicas' KV stores and the PS "
                         "shards live (default cuda)")
    a = ap.parse_args(argv)
    if a.mixed:
        weights = [int(x) for x in a.mixed_weights.split(",")] \
            if a.mixed_weights else None
        run_mixed_press(a.mixed.split(","), weights=weights,
                        n_shards=a.shards, vocab=a.vocab, dim=a.dim,
                        train_steps=a.train_steps, duration_s=a.duration,
                        device=a.device, out=sys.stdout)
        return
    if not a.cluster:
        ap.error("--cluster N or --mixed SHAPES is required")
    text = a.input
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    req = json.loads(text)
    timeout_ms = max(a.timeout_ms, 5000)
    if a.models:
        run_multimodel_press(
            a.cluster, [m for m in a.models.split(",") if m],
            duration_s=a.duration, threads=a.threads,
            timeout_ms=timeout_ms, device=a.device, out=sys.stdout)
    elif a.kill_router_after is not None:
        run_router_kill_press(a.cluster, req, duration_s=a.duration,
                              threads=a.threads,
                              kill_router_after=a.kill_router_after,
                              timeout_ms=timeout_ms, device=a.device,
                              out=sys.stdout)
    else:
        run_cluster_press(a.cluster, req, duration_s=a.duration,
                          threads=a.threads, timeout_ms=timeout_ms,
                          kill_replica_after=a.kill_replica_after,
                          slo=a.slo, device=a.device, out=sys.stdout)


if __name__ == "__main__":
    main()
