#!/usr/bin/env python3
"""When does ``torch.profiler`` see no device event in a window?  A
probe of ``chip_smoke.launches_per_call``'s "blind" windows on one
NVIDIA GPU.

    python3 profiler_windows.py [--windows N]

Opens ``--windows`` profiler windows (CPU and CUDA activities, as
``chip_smoke.launches_per_call`` opens them) around one small kernel
call each -- an int8 fill and a 64x64 f32 matmul -- under each of these
conditions, one after the other in this process:

  idle        nothing else runs
  threads     4 Python threads launch CUDA work (a 256x256 matmul) on
              the default stream in a loop, as decode engines do
  streams     the same 4 threads, each on its own CUDA stream
  sleepers    4 Python threads alive and asleep (no CUDA work)
  server      a port ``rpc.Server`` started (its native worker and
              epoll threads) and left running
  child       after a child process was started and reaped (step 6 and
              step 14 of ``chip_smoke.py`` start some)
  big_alloc   after 8 GiB were allocated on the card and given back
              (``empty_cache``), as the flagship train step does
  after_big   after one long profiler session of ~20000 kernel
              launches (a profiled serving pass's size)

and counts per condition the windows with no CUDA event at all, and of
those the ones whose CPU events were missing too.  Prints the card's
name and power limit, then one JSON object.  Exits non-zero without a
card.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    marker = torch.zeros(1, dtype=torch.int8, device=dev)
    a = torch.randn(64, 64, device=dev)

    def body():
        marker.fill_(1)
        torch.mm(a, a)

    def windows(n):
        blind = cpu_blind = 0
        for _ in range(n):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                body()
                torch.cuda.synchronize()
            evs = prof.events()
            n_cuda = sum(1 for e in evs if e.device_type == DeviceType.CUDA)
            if n_cuda == 0:
                blind += 1
                if not any(e.device_type == DeviceType.CPU for e in evs):
                    cpu_blind += 1
        return {"windows": n, "blind": blind, "blind_without_cpu": cpu_blind}

    def with_threads(n, streams, cuda=True):
        stop = threading.Event()

        def work():
            s = torch.cuda.Stream() if streams else None
            x = torch.randn(256, 256, device=dev)
            with torch.cuda.stream(s) if s is not None else _null():
                while not stop.is_set():
                    if cuda:
                        torch.mm(x, x)
                        torch.cuda.current_stream().synchronize()
                    time.sleep(0.001)

        ts = [threading.Thread(target=work, daemon=True) for _ in range(4)]
        for t in ts:
            t.start()
        try:
            return windows(n)
        finally:
            stop.set()
            for t in ts:
                t.join(10)

    body()
    torch.cuda.synchronize()
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    out["idle"] = windows(args.windows)
    out["threads"] = with_threads(args.windows, streams=False)
    out["streams"] = with_threads(args.windows, streams=True)
    out["sleepers"] = with_threads(args.windows, streams=False, cuda=False)
    import brpc_tpu_torch.rpc as rpc
    server = rpc.Server()
    server.start("127.0.0.1", 0)
    try:
        out["server"] = windows(args.windows)
    finally:
        server.stop()
        server.join()
    subprocess.run([sys.executable, "-c", "pass"], check=True, timeout=60)
    out["child"] = windows(args.windows)
    big = torch.empty(8 << 30, dtype=torch.uint8, device=dev)
    big.fill_(1)
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["big_alloc"] = windows(args.windows)
    x = torch.randn(32, 32, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20000):
            x.add_(1.0)
        torch.cuda.synchronize()
    out["big_session_cuda_events"] = sum(
        1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    out["after_big"] = windows(args.windows)
    out["idle_again"] = windows(args.windows)
    print(json.dumps(out), flush=True)
    return 0


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


if __name__ == "__main__":
    sys.exit(main())
