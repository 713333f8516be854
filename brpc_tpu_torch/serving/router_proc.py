"""The cluster router as its own process (a copy of
``brpc_tpu/serving/router_proc.py``).

A durable session only means something across a process death.  This
module runs a ``ClusterRouter`` as its own OS process over remote-only
replicas, adopting (or creating) a session WAL, so a harness can
``SIGKILL`` it mid-generation and start a successor over the same WAL:

    python -m brpc_tpu_torch.serving.router_proc '{"wal": ..., "replicas":
        [...], ...}'

The child prints ``ROUTER_PORT <port>`` on stdout once it serves, then
blocks until its stdin closes (the parent's handle going away is the
shutdown signal, so an orphaned router never outlives its harness).
:func:`spawn_router` wraps the Popen and the port handshake.  The router
touches no device, so the child needs no card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence


def run_router(cfg: dict):
    """Build and start a router from a config dict (see main());
    returns ``(router, server)``.  Factored out of main() so a test can
    drive the same path in-process."""
    from .. import rpc
    from .router import ClusterRouter, SessionTable, register_router

    wal_path = cfg.get("wal")
    sessions: Optional[SessionTable] = None
    if wal_path and os.path.exists(wal_path):
        sessions = SessionTable.recover(
            wal_path, keep_finished=int(cfg.get("keep_finished", 512)))
    router = ClusterRouter(
        list(cfg["replicas"]),
        sessions=sessions,
        wal=(wal_path if sessions is None else None),
        max_sessions=int(cfg.get("max_sessions", 256)),
        check_interval_s=float(cfg.get("check_interval_s", 0.05)),
        replicate_sessions=bool(cfg.get("replicate_sessions", True)),
        replication_factor=int(cfg.get("replication_factor", 2)),
        page_tokens=int(cfg.get("page_tokens", 8)),
        progress_timeout_s=float(cfg.get("progress_timeout_s", 30.0)),
        name=str(cfg.get("name", "router_proc")),
        timeout_ms=int(cfg.get("timeout_ms", 20_000)))
    srv = rpc.Server()
    register_router(srv, router)
    srv.start(cfg.get("host", "127.0.0.1"), int(cfg.get("port", 0)))
    return router, srv


def main(argv: Sequence[str]) -> int:
    cfg = json.loads(argv[1]) if len(argv) > 1 else {}
    router, srv = run_router(cfg)
    print(f"ROUTER_PORT {srv.port}", flush=True)
    try:
        # block until the parent closes our stdin (or kills us — the
        # whole point of this process is being killable)
        while sys.stdin.readline():
            pass
    except KeyboardInterrupt:
        pass
    router.close(timeout_s=2.0)
    srv.stop()
    srv.join()
    return 0


def spawn_router(wal_path: str, replica_addrs: Sequence[str], *,
                 timeout_s: float = 20.0, **cfg):
    """Launch a router subprocess over `wal_path` + remote replicas;
    returns ``(proc, addr)`` once the child reports its port.  Kill it
    with ``proc.kill()`` (SIGKILL — no goodbye, that's the test) and
    spawn a successor over the same ``wal_path`` to adopt the fleet."""
    cfg = dict(cfg)
    cfg["wal"] = str(wal_path)
    cfg["replicas"] = [str(a) for a in replica_addrs]
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.serving.router_proc",
         json.dumps(cfg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, cwd=repo_root, text=True)
    deadline = time.monotonic() + timeout_s
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("ROUTER_PORT "):
            port = int(line.split()[1])
            return proc, f"127.0.0.1:{port}"
        if not line and proc.poll() is not None:
            break
    proc.kill()
    raise RuntimeError(
        f"router subprocess never reported a port (last line: {line!r})")


if __name__ == "__main__":
    sys.exit(main(sys.argv))
