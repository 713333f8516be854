"""Real model serving over the port's own RPC front.

    python3 -m brpc_tpu_torch.examples.llm_server             # on cuda
    python3 -m brpc_tpu_torch.examples.llm_server --device cpu

A ``TransformerRunner`` (random weights from a seed) whose K/V live in
the paged KV cache, behind ``Serving.Generate`` on the port's
``Server``; a port ``Channel`` streams the generated tokens back, and
each stream is printed beside the port's cache-less ``dense_generate``:

  1. a cold prompt: the paged decode equals the dense model;
  2. the same prompt again: identical tokens, the prompt's prefix served
     from the radix cache (the server's advisory ``prefix_hit``);
  3. a prompt sharing only the "system" prefix: that part is reused.

The counterpart of the JAX package's ``examples/llm_server.py``.  It
runs on the card unless ``--device cpu`` is passed; without a card and
without that flag it raises.
"""
from __future__ import annotations

import argparse
import json
import threading

import torch

from .. import rpc
from ..models import (TransformerConfig, TransformerRunner, dense_generate,
                      init_runner_params, make_store_for)
from ..serving import DecodeEngine, register_serving


class _Collector(rpc.StreamHandler):
    def __init__(self):
        self.tokens = []
        self.terminal = None
        self.done = threading.Event()

    def on_received_messages(self, stream, messages):
        for m in messages:
            d = json.loads(m)
            if "token" in d:
                self.tokens.append(d["token"])
            if d.get("done"):
                self.terminal = d
                self.done.set()

    def on_closed(self, stream):
        self.done.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig()
    params = init_runner_params(cfg, args.seed, device=args.device)
    store = make_store_for(cfg, page_tokens=4, max_blocks=32,
                           device=args.device, name="llm")
    runner = TransformerRunner(params, cfg, store=store, device=args.device,
                               name="llm")
    engine = DecodeEngine(runner=runner, store=store, num_slots=4,
                          max_pages_per_slot=32, prefill_buckets=(8, 16, 32),
                          device=args.device, name="llm")
    server = rpc.Server()
    register_serving(server, engine=engine)
    server.start("127.0.0.1", 0)
    print(f"LLM server on 127.0.0.1:{server.port} ({engine.device})")
    ch = rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=60_000)
    n = args.new_tokens

    def generate(prompt):
        col = _Collector()
        cntl = rpc.Controller()
        rpc.stream_create(cntl, col)
        resp = ch.call_sync("Serving", "Generate",
                            {"prompt": prompt, "max_new_tokens": n},
                            serializer="json", cntl=cntl)
        if not col.done.wait(300) or col.terminal != {"done": True}:
            raise RuntimeError(f"generation failed: {col.terminal}")
        return col.tokens, resp["prefix_hit"]

    try:
        system = [7, 99, 23, 54]                  # "system prompt" prefix
        prompt = system + [5, 17, 42, 9]
        toks, hit = generate(prompt)
        ref = dense_generate(params, cfg, prompt, n, device=args.device)
        print(f"\n[1] cold generate   prefix_hit={hit:2d}  tokens={toks}")
        print(f"    dense_generate (no cache, full recompute): {ref}")
        if toks != ref:
            raise RuntimeError("the paged decode diverged from the dense "
                               "model")
        toks2, hit2 = generate(prompt)
        print(f"[2] same prompt     prefix_hit={hit2:2d}  tokens={toks2}"
              f"   <- identical output, prefill skipped")
        if toks2 != toks or hit2 <= 0:
            raise RuntimeError("the warm generation differs or missed "
                               "the cache")
        other = system + [61, 33, 88, 2]
        toks3, hit3 = generate(other)
        ref3 = dense_generate(params, cfg, other, n, device=args.device)
        print(f"[3] shared system   prefix_hit={hit3:2d}  tokens={toks3}"
              f"   <- only the system prefix reused")
        print(f"    dense_generate: {ref3}")
        if toks3 != ref3:
            raise RuntimeError("the shared-prefix generation diverged")
        st = store.stats()
        print(f"\nkvcache: hit_tokens={store.hit_tokens}  "
              f"live_seqs={st['live_seqs']}")
    finally:
        server.stop()
        server.join()
        engine.close()
        store.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
