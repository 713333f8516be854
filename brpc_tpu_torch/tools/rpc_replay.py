"""rpc_replay -- send again the requests that ``rpc_dump`` captured (a
copy of ``brpc_tpu/tools/rpc_replay.py`` over the port's channel).

Reads ``.rdump`` recordio files (meta = the wire ``RpcMeta`` bytes,
body = the payload as it arrived) and issues each request again, byte
for byte, against a target server, with a fresh correlation id and no
retry.  A captured request that carried a client stream (a streaming
``Serving.Generate``) is sent with its stream id as captured, and no
stream of the replaying client answers to that id: the server accepts
the call and its stream frames find no reader.

Example:
  python -m brpc_tpu_torch.tools.rpc_replay --server 127.0.0.1:8000 \\
      --dir ./rpc_dump --qps 1000 --times 1
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from .. import errors
from ..butil.endpoint import str2endpoint
from ..butil.recordio import RecordReader
from ..bvar import LatencyRecorder
from ..rpc import meta as M
from ..rpc.channel import CallManager, SocketMap, _CallState, _cid_counter
from ..rpc.controller import Controller, OneShotEvent
from ..rpc.transport import Transport


def load_records(path_or_dir: str) -> list[tuple[bytes, bytes]]:
    """Every ``(meta, body)`` of one ``.rdump`` file, or of every one in
    a directory (in name order)."""
    paths = ([path_or_dir] if os.path.isfile(path_or_dir)
             else sorted(glob.glob(os.path.join(path_or_dir, "*.rdump"))))
    records: list[tuple[bytes, bytes]] = []
    for p in paths:
        with open(p, "rb") as f:
            records.extend(RecordReader(f))
    return records


def replay_one(ep, meta_bytes: bytes, body: bytes,
               timeout_ms: int = 1000) -> Controller:
    """Issue one captured request again with a fresh correlation id;
    returns its controller (the caller joins it)."""
    meta = M.RpcMeta.decode(meta_bytes)
    cntl = Controller()
    cntl.timeout_ms = timeout_ms
    cntl.max_retry = 0
    cntl.correlation_id = next(_cid_counter)
    cntl._start_us = int(time.monotonic() * 1e6)
    cntl._done_event = OneShotEvent()
    meta.correlation_id = cntl.correlation_id
    meta.attempt = 0
    mgr = CallManager.instance()
    st = _CallState(cntl, _NullChannel(), meta, body, None)
    mgr.register(st)
    t = Transport.instance()
    cid = cntl.correlation_id
    st.deadline_timer = t.schedule(timeout_ms / 1e3,
                                   lambda: mgr.on_deadline(cid))
    try:
        conn = SocketMap.instance().get_connection(ep)
    except (ConnectionError, OSError):
        cntl.set_failed(errors.ECONNREFUSED, f"cannot connect {ep}")
        mgr._finish(st)
        return cntl
    mgr.bind_socket(cid, conn.sid, 0)
    if t.write_frame(conn.sid, meta.encode(), body) != 0:
        cntl.set_failed(errors.EFAILEDSOCKET, "write failed")
        mgr._finish(st)
    return cntl


class _NullChannel:
    """A replay has no retry and no balancer: the channel stand-in the
    call table asks."""

    def _should_retry(self, st, owner_attempt=None):
        return False

    def _on_call_end(self, st):
        pass


def run_replay(server: str, path: str, qps: int = 0, times: int = 1,
               timeout_ms: int = 1000, out=sys.stderr) -> dict:
    """Replay every record under ``path`` ``times`` times against
    ``server`` (at most ``qps`` a second, 0 = as fast as answered, at
    most 128 in flight); prints and returns the summary."""
    ep = str2endpoint(server)
    records = load_records(path)
    if not records:
        print(json.dumps({"error": "no records found", "path": path}),
              file=out)
        return {"replayed": 0, "errors": 0}
    rec = LatencyRecorder("rpc_replay")
    nerr = 0
    nok = 0
    interval = 1.0 / qps if qps > 0 else 0.0
    t_start = time.monotonic()
    next_at = t_start
    inflight: list[Controller] = []
    for _ in range(times):
        for meta_bytes, body in records:
            if interval > 0:
                now = time.monotonic()
                if now < next_at:
                    time.sleep(next_at - now)
                next_at += interval
            inflight.append(replay_one(ep, meta_bytes, body, timeout_ms))
            if len(inflight) >= 128:  # a bounded pipeline window
                done = inflight.pop(0)
                done.join()
                nok, nerr = _account(done, rec, nok, nerr)
    for cntl in inflight:
        cntl.join()
        nok, nerr = _account(cntl, rec, nok, nerr)
    elapsed = time.monotonic() - t_start
    summary = {
        "replayed": nok,
        "errors": nerr,
        "qps": round(nok / elapsed, 1) if elapsed > 0 else 0,
        "p50_us": rec.latency_percentile(0.5),
        "p99_us": rec.latency_percentile(0.99),
        "elapsed_s": round(elapsed, 2),
    }
    print(json.dumps(summary), file=out)
    return summary


def _account(cntl, rec, nok, nerr):
    if cntl.error_code == 0:
        rec.add(cntl.latency_us)
        return nok + 1, nerr
    return nok, nerr + 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server", required=True, help="host:port")
    ap.add_argument("--dir", dest="path", required=True,
                    help=".rdump file or directory of them")
    ap.add_argument("--qps", type=int, default=0, help="0 = unthrottled")
    ap.add_argument("--times", type=int, default=1,
                    help="replay the capture N times")
    ap.add_argument("--timeout-ms", type=int, default=1000)
    a = ap.parse_args(argv)
    run_replay(a.server, a.path, qps=a.qps, times=a.times,
               timeout_ms=a.timeout_ms, out=sys.stdout)


if __name__ == "__main__":
    main()
