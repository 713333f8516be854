#!/usr/bin/env python3
"""What the port's always-on hotspot sampler costs a serving process on
one NVIDIA GPU, at the load of ``chip_smoke.py``'s step 6.

    python3 sampler_cost.py [--checkout DIR] [--pairs N] [--window-s S]

Serves the wide configuration of ``chip_smoke.py`` (vocab 32768,
d_model 1024, 8 layers, H8/Hkv4, D128, d_ff 4096; random weights and 8
prompts of 200 tokens from step 4's seed) behind one port ``Server``
with ``Serving.Generate``, and times windows of back-to-back warm
passes: 8 concurrent 32-token streams through the port's ``Channel``,
as step 6 sends them.  A window runs whole passes until ``--window-s``
seconds have gone.  Where the checkout's port has the sampler
(``brpc_tpu_torch/builtin/sampler.py``), the windows alternate
``hotspot_sampler_enabled`` off and on, ``--pairs`` pairs, which of the
two runs first alternating too.  Where it has none (``--checkout`` at an
older tree, to compare two trees on one card: run old, new, new, old),
``2 * --pairs`` windows run as the tree is ("none").  Every pass's
streams must equal the first pass's.  Prints the card's name and power
limit, then one JSON object: each window's tokens/s by kind, their
medians, and each pair's on/off ratio.  Exits non-zero without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout",
                    default=os.path.dirname(os.path.abspath(__file__)),
                    help="the tree whose port and chip_smoke.py to run")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--window-s", type=float, default=3.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sampler_cost: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.checkout)
    if not os.path.isdir(os.path.join(root, "brpc_tpu_torch")):
        print(f"sampler_cost: {root} holds no brpc_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    import brpc_tpu_torch._core.build as cbuild
    import brpc_tpu_torch.ops._build as kbuild
    kbuild.build()
    cbuild.build()
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch import flags
    try:
        from brpc_tpu_torch.builtin.sampler import HotspotSampler
    except ImportError:          # a tree from before the sampler
        HotspotSampler = None

    cfg = models.TransformerConfig(vocab=32768, d_model=1024, n_layers=8,
                                   n_heads=8, n_kv_heads=4, head_dim=128,
                                   d_ff=4096)
    seed, prompt_len = 12, 200
    params = models.init_runner_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).tolist()
               for _ in range(cs.N_REQUESTS)]
    store = models.make_store_for(cfg, page_tokens=16, max_blocks=64,
                                  device=dev, name="sampler_cost")
    runner = models.TransformerRunner(params, cfg, store=store, device=dev,
                                      name="sampler_cost")
    engine = serving.DecodeEngine(
        runner=runner, store=store, num_slots=8, max_pages_per_slot=16,
        prefill_buckets=(16, 64, 256), device=dev, name="sampler_cost")
    server = rpc.Server()
    serving.register_serving(server, engine=engine)
    server.start("127.0.0.1", 0)
    toks = cs.N_REQUESTS * cs.NEW_TOKENS

    def set_sampler(on):
        flags.set_flag("hotspot_sampler_enabled", on)
        if on:
            HotspotSampler.ensure_started()
        else:
            HotspotSampler.instance().stop()
        cs.check(HotspotSampler.instance().running == on,
                 f"the sampler did not turn {'on' if on else 'off'}")

    try:
        first = cs.rpc_generate_all(server.port, prompts, "cold")[0]

        def window(kind):
            if kind != "none":
                set_sampler(kind == "on")
            passes, t0 = 0, time.perf_counter()
            while True:
                streams = cs.rpc_generate_all(server.port, prompts,
                                              f"{kind} window")[0]
                cs.check(streams == first,
                         f"{kind} window: streams differ from the first")
                passes += 1
                wall = time.perf_counter() - t0
                if wall >= args.window_s:
                    return passes * toks / wall, passes

        window("on" if HotspotSampler else "none")     # warm-up, dropped
        got = {}
        for i in range(args.pairs):
            order = (("none", "none") if HotspotSampler is None else
                     ("off", "on") if i % 2 == 0 else ("on", "off"))
            for kind in order:
                got.setdefault(kind, []).append(window(kind))
        if HotspotSampler is not None:
            set_sampler(True)
    finally:
        server.stop()
        server.join()
        engine.close()
        store.clear()
    rates = {k: [r for r, _ in v] for k, v in got.items()}
    out = {"card": card, "checkout": root, "window_s": args.window_s,
           "passes": {k: [n for _, n in v] for k, v in got.items()},
           "tokens_per_s": rates,
           "median_tokens_per_s": {k: float(np.median(v))
                                   for k, v in rates.items()}}
    if "on" in rates:
        ratio = [b / a for a, b in zip(rates["off"], rates["on"])]
        out["on_over_off"] = ratio
        out["on_over_off_median"] = float(np.median(ratio))
        out["on_over_off_quartiles"] = [float(q) for q in
                                        np.percentile(ratio, [25, 75])]
        out["pairs_slower_on"] = sum(r < 1 for r in ratio)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:
        print(f"sampler_cost: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        raise
