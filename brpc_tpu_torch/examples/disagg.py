"""Disaggregated prefill/decode across two processes.

    python3 -m brpc_tpu_torch.examples.disagg             # on cuda
    python3 -m brpc_tpu_torch.examples.disagg --device cpu

Spawns a DECODE process (a ``KVCacheStore``, a ``TransformerRunner``
behind a ``DecodeEngine``, the migration splice and ``Serving.Generate``
on a port ``Server``) and a PREFILL process (its own store and runner,
``register_disagg_prefill`` shipping pages to the decode address), both
with the same random weights from ``--seed``.  This process pairs them
with a ``DisaggCoordinator`` and runs one generation across the split:
the prefill process runs the prompt's prefill (the paged kernel once
per layer) and its full pages move to the decode process, which
prefix-hits them instead of re-prefilling.  The stream is checked
against the port's cache-less ``dense_generate`` here; a mismatch or a
recompute fallback exits non-zero.

The counterpart of the JAX package's ``examples/disagg.py``.  The port
has no transfer fabric: the pages travel host-serialized on the
``_kvmig`` envelope.  ``--role decode|prefill`` runs one side alone
(it prints ``PORT=<port>``, serves until its standard input closes, then
prints ``STATS=<json>`` and exits).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

CONFIGS = {
    "a": {},
    "b": dict(vocab=32768, d_model=1024, n_layers=8, n_heads=8,
              n_kv_heads=4, head_dim=128, d_ff=4096),
}


def config_of(spec: str):
    """``--config``: a name in CONFIGS or a JSON object of
    ``TransformerConfig`` fields."""
    from ..models import TransformerConfig
    return TransformerConfig(**(CONFIGS[spec] if spec in CONFIGS
                                else json.loads(spec)))


def build(cfg_spec, seed, device, page_tokens, max_blocks, name):
    from ..models import (TransformerRunner, init_runner_params,
                          make_store_for)
    cfg = config_of(cfg_spec)
    params = init_runner_params(cfg, seed, device=device)
    store = make_store_for(cfg, page_tokens=page_tokens,
                           max_blocks=max_blocks, device=device, name=name)
    runner = TransformerRunner(params, cfg, store=store, device=device,
                               name=name)
    return cfg, params, store, runner


def serve_role(args) -> int:
    """One side of the split in this process: serve until stdin closes,
    then shut down and print this side's state."""
    from .. import rpc
    from ..migrate import register_disagg_decode, register_disagg_prefill
    from ..ops import paged_attention as pa
    from ..serving import DecodeEngine, EngineSupervisor
    cfg, _, store, runner = build(args.config, args.seed, args.device,
                                  args.page_tokens, args.max_blocks,
                                  args.role)
    free0 = store.pagepool.pool.stats()["classes"]
    server = rpc.Server(enable_dcn=True, dcn_device=args.device)
    engine = None
    if args.role == "decode":
        def factory():
            return DecodeEngine(runner=runner, store=store,
                                num_slots=args.num_slots,
                                max_pages_per_slot=args.max_pages,
                                prefill_buckets=(16, 64, 256),
                                device=args.device, name="decode")
        # the overload ladder held off: this role serves a fixed load
        calm = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
                 "queue_depth": 1e9},) * 3
        engine = EngineSupervisor(factory, store=store, ladder=calm,
                                  name="decode") \
            if args.supervised else factory()
        register_disagg_decode(server, store, engine)
    else:
        register_disagg_prefill(server, store, args.decode_addr,
                                runner=runner, name="prefill")
    server.start("127.0.0.1", 0)
    pa.paged_attention.launches = 0
    print(f"PORT={server.port}", flush=True)
    sys.stdin.read()                 # the parent closes it to stop us
    server.stop()
    server.join()
    st = store.stats()
    if engine is not None:
        engine.close()
    store.clear()
    print("STATS=" + json.dumps({
        "live_seqs": st["live_seqs"], "hit_tokens": st["hit_tokens"],
        "imported_pages": st["imported_pages"],
        "paged_launches": pa.paged_attention.launches,
        "pool_at_baseline": store.pagepool.blocks_leased() == 0
        and store.pagepool.pool.stats()["classes"] == free0}), flush=True)
    return 0


def spawn(*role_args, timeout_s=300):
    """Start ``--role ...`` in a child process; returns it and its port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.examples.disagg", *role_args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("PORT="):
            return proc, int(line.split("=", 1)[1])
        if not line and proc.poll() is not None:
            raise RuntimeError(f"child {role_args[:2]} died during startup "
                               f"({proc.returncode})")
    proc.kill()
    proc.wait()
    raise RuntimeError(f"child {role_args[:2]} never printed its port")


def stop(proc, timeout_s=120) -> dict:
    """Close the child's stdin, wait for it, return its STATS."""
    out, _ = proc.communicate(input="", timeout=timeout_s)
    stats = [ln for ln in out.splitlines() if ln.startswith("STATS=")]
    if proc.returncode != 0 or not stats:
        raise RuntimeError(f"child exited {proc.returncode}: {out[-2000:]}")
    return json.loads(stats[-1].split("=", 1)[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--config", default="a",
                    help=f"one of {sorted(CONFIGS)} or a JSON object of "
                         f"TransformerConfig fields")
    ap.add_argument("--page-tokens", type=int, default=4)
    ap.add_argument("--max-blocks", type=int, default=32)
    ap.add_argument("--max-pages", type=int, default=32)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--role", choices=("decode", "prefill"))
    ap.add_argument("--decode-addr")
    ap.add_argument("--supervised", action="store_true",
                    help="decode role: an EngineSupervisor over the engine")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.role:
        return serve_role(args)

    from ..migrate import DisaggCoordinator
    from ..models import dense_generate, init_runner_params
    common = ["--config", args.config, "--seed", str(args.seed),
              "--page-tokens", str(args.page_tokens),
              "--max-blocks", str(args.max_blocks)]
    if args.device:
        common += ["--device", args.device]
    print("starting the decode process ...", flush=True)
    dec, dec_port = spawn("--role", "decode", *common)
    pre = None
    try:
        print(f"  decode on 127.0.0.1:{dec_port}")
        print("starting the prefill process (shipping pages to decode) ...",
              flush=True)
        pre, pre_port = spawn("--role", "prefill", "--decode-addr",
                              f"127.0.0.1:{dec_port}", *common)
        print(f"  prefill on 127.0.0.1:{pre_port}")
        co = DisaggCoordinator(f"127.0.0.1:{pre_port}",
                               f"127.0.0.1:{dec_port}", device=args.device)
        ta, tb = co.pair()
        print(f"paired: prefill pid {ta['pid']} ({ta['platform']}), decode "
              f"pid {tb['pid']} ({tb['platform']}), fabric "
              f"{ta.get('xfer')}/{tb.get('xfer')} (host-serialized)")
        cfg = config_of(args.config)
        prompt = [(50 + 7 * j) % cfg.vocab for j in range(13)]
        out = co.generate(prompt, args.new_tokens, timeout_s=300)
        info = out["prefill"]
        print(f"prefill handoff: {json.dumps(info)}; decode prefix_hit "
              f"{out['prefix_hit']}")
        print(f"tokens:         {out['tokens']}")
        params = init_runner_params(cfg, args.seed, device=args.device)
        ref = dense_generate(params, cfg, prompt, args.new_tokens,
                             device=args.device)
        print(f"dense_generate: {ref}")
        if out["error"] is not None or out["tokens"] != ref:
            raise RuntimeError("the split generation diverged from the "
                               "dense model")
        if info["recompute_fallback"] or not out["prefix_hit"]:
            raise RuntimeError("the page hand-off fell back to recompute")
    finally:
        pst = stop(pre) if pre is not None else None
        dst = stop(dec)
    print(f"prefill process: {json.dumps(pst)}")
    print(f"decode process:  {json.dumps(dst)}")
    print(f"OK: {info['migrated_pages']} pages moved process to process; "
          f"the decode side never re-prefilled them")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
