"""rpc_press's cluster mode (a copy of that part of
``brpc_tpu/tools/rpc_press.py``): spin up N in-process serving replicas
behind a :class:`~brpc_tpu_torch.serving.ClusterRouter` and press full
generations through the front door.

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
replica S seconds in, so sessions resume under load.
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


def run_cluster_press(n_replicas: int, request,
                      duration_s: float = 10.0, threads: int = 4,
                      timeout_ms: int = 20_000, request_factory=None,
                      kill_replica_after: float | None = None,
                      device=None, out=sys.stderr) -> dict:
    """``--cluster N`` mode (see the module docstring).  ``request`` is
    ``{"prompt": [...], "max_new_tokens": n}``; ``request_factory(k)``,
    if given, returns worker k's per-call request generator instead."""
    from ..serving import RouterClient

    replicas, router, rsrv, raddr = spin_up_cluster(
        n_replicas, page_tokens=8, commit_live_pages=True,
        replicate_sessions=True, max_sessions=max(64, 8 * threads),
        name_prefix="press_cl", timeout_ms=timeout_ms, device=device)
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
        print(json.dumps(summary), file=out)
    finally:
        tear_down_cluster(replicas, router, rsrv)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cluster", type=int, required=True, metavar="N",
                    help="spin up N in-process serving replicas behind "
                         "a ClusterRouter and press generations "
                         "through the front door")
    ap.add_argument("--kill-replica-after", type=float, default=None,
                    metavar="S",
                    help="kill one replica S seconds into the run so "
                         "session resume runs under load")
    ap.add_argument("--input", default="{}",
                    help="JSON request body, or @file.json")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--timeout-ms", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="where the replicas' KV stores live (default "
                         "cuda)")
    a = ap.parse_args(argv)
    text = a.input
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    run_cluster_press(a.cluster, json.loads(text), duration_s=a.duration,
                      threads=a.threads,
                      timeout_ms=max(a.timeout_ms, 5000),
                      kill_replica_after=a.kill_replica_after,
                      device=a.device, out=sys.stdout)


if __name__ == "__main__":
    main()
