"""parallel_http -- mass concurrent HTTP fetcher (a copy of
``brpc_tpu/tools/parallel_http.py``): fetch many URLs concurrently and
report success and failure counts and latency percentiles.

Example:
  python -m brpc_tpu_torch.tools.parallel_http --url-file urls.txt --threads 32
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from queue import Empty, Queue

from ..bvar import LatencyRecorder


def fetch_all(urls: list[str], threads: int = 16, timeout: float = 5.0,
              out=sys.stderr) -> dict:
    q: Queue[str] = Queue()
    for u in urls:
        q.put(u)
    rec = LatencyRecorder("parallel_http")
    ok = [0]
    fail = [0]
    mu = threading.Lock()
    results: dict[str, int] = {}

    def worker():
        while True:
            try:
                u = q.get_nowait()
            except Empty:
                return
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(u, timeout=timeout) as r:
                    r.read()
                    status = r.status
                rec.add(int((time.monotonic() - t0) * 1e6))
                with mu:
                    ok[0] += 1
                    results[u] = status
            except Exception:
                with mu:
                    fail[0] += 1
                    results[u] = -1

    t_start = time.monotonic()
    ts = [threading.Thread(target=worker, daemon=True)
          for _ in range(min(threads, max(1, len(urls))))]
    [t.start() for t in ts]
    [t.join() for t in ts]
    summary = {
        "fetched": ok[0],
        "failed": fail[0],
        "p50_us": rec.latency_percentile(0.5),
        "p99_us": rec.latency_percentile(0.99),
        "elapsed_s": round(time.monotonic() - t_start, 2),
    }
    print(json.dumps(summary), file=out)
    summary["results"] = results
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--url-file", help="file with one URL per line")
    g.add_argument("--url", action="append", help="URL (repeatable)")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=5.0)
    a = ap.parse_args(argv)
    urls = a.url or []
    if a.url_file:
        with open(a.url_file) as f:
            urls.extend(line.strip() for line in f if line.strip())
    fetch_all(urls, threads=a.threads, timeout=a.timeout, out=sys.stdout)


if __name__ == "__main__":
    main()
