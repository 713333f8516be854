#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports nothing of JAX or of the JAX package (``brpc_tpu``), and:

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the CUDA kernels from ``brpc_tpu_torch/csrc`` with ``nvcc``
     (one process per source, in parallel) into ``build/torch_kernels/``,
     prints ptxas' registers and spills, and counts the tensor-core
     (HMMA) instructions in each library's SASS (``cuobjdump``): the
     flash kernel must have some;
  3. kernel phase: calls each kernel's wrapper on the card at the
     serving path's shapes (and the paged kernel at a ~2048-key
     context) and holds it against its plain PyTorch version (f32 atol
     1e-4, bf16 2e-2), timing kernel, plain version and -- for flash
     attention -- ``scaled_dot_product_attention`` (timed here only; the
     port never calls it) with CUDA events, both as issued eagerly and
     replayed from a CUDA graph (device time); each row carries its
     bound (bytes at 3.35 TB/s, or operations at the rate of its type:
     bf16 989 TFLOP/s, f32 as 3xTF32 at 495/3 TFLOP/s), what the kernel
     achieved, and the CUDA launches of one call (``torch.profiler``);
  4. serving phase, for the default model (``TransformerConfig()``) and
     for the wide one (vocab 32768, d_model 1024, 8 layers, H8/Hkv4,
     D128, d_ff 4096): random weights from a seed, 8 concurrent
     requests through ``DecodeEngine``, every stream equal to the port's
     ``dense_generate`` on the card, the same prompts again warm (prefix
     hit > 0, identical tokens), the page pool back at its baseline, and
     both kernels launched on the way (launch counts reset just before
     each serving run and read just after); then one more warm pass
     under ``torch.profiler`` for the device's busy share;
  5. prints ``{"kernels": [...]}``, the card line, and as the LAST line
     ``{"ok": true, "device": {...}}``.

Any failed check, build or launch exits non-zero before the result.
TF32 is off for every f32 matmul and convolution.  The full record of
the run goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
# The least time for an f32 product at f32 accuracy is 3xTF32 on the
# tensor cores (three tf32 products per f32 one at 495 TFLOP/s), which
# beats the 67 TFLOP/s of f32 outside them; bf16 runs at 989 TFLOP/s.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
RATE = {"bytes": "HBM 3.35 TB/s",
        "float32": "3xTF32 tensor cores, 495 TFLOP/s / 3",
        "bfloat16": "bf16 tensor cores, 989 TFLOP/s"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NEW_TOKENS = 32
N_REQUESTS = 8


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ---- timing ----------------------------------------------------------------

def time_ms(fn, iters=None, warmup=2):
    """Mean milliseconds per call on the current stream (CUDA events),
    after warm-up; the iteration count adapts to ~100 ms of work.  When
    the host enqueues slower than the device runs, this is host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if iters is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = time.perf_counter() - t0
        iters = int(min(50, max(3, 0.1 / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(fn):
    """``(device_ms, eager_ms)`` per call.  eager: calls issued one after
    another from Python, as the serving loop issues them.  device: the
    same calls captured in one CUDA graph and replayed, so the host's
    launch overhead drops out and what remains is the device's time."""
    import torch
    eager = time_ms(fn)
    reps = max(1, min(20, int(2.0 / max(eager, 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    device = time_ms(graph.replay) / reps
    del graph
    torch.cuda.synchronize()
    return device, eager


def bound(nbytes, flops, dtype, ms):
    """The row's bound (ms, what bounds it, the rate) and what the kernel
    achieved against it: GB/s when bytes bound, TFLOP/s when operations
    do, and the bound's share of the measured time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = t_bytes >= t_ops
    b_ms = t_bytes if by_bytes else t_ops
    return {"bound_ms": b_ms, "bound_by": "bytes" if by_bytes
            else "operations", "bound_rate": RATE["bytes" if by_bytes
                                                  else dtype],
            "achieved": (f"{nbytes / ms / 1e6:.1f} GB/s" if by_bytes
                         else f"{flops / ms / 1e9:.1f} TFLOP/s"),
            "share_of_bound": b_ms / ms}


def launches_per_call(fn):
    """CUDA kernels (and copies) one call of ``fn`` puts on the device,
    counted by ``torch.profiler`` over one warm call; "not measured"
    where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (len(names), names) if names else ("not measured", [])


# ---- kernel phase: paged attention -----------------------------------------

def paged_case(dev, cfg, *, page_tokens, n, mp, prefill, extra, seed,
               prompt_len, standalone=False):
    """Inputs shaped as the serving path gives them to the paged kernel:
    the last layer's K/V slices of a real PagePool arena, decode rows
    with their own tables at ~prompt_len keys, or one prefill bucket of
    causal rows over one table.  ``standalone``: an arena tensor of the
    same layout allocated here, for more pages than a pool's block class
    holds (the long-context row)."""
    import torch
    import brpc_tpu_torch.kvcache as kvcache
    import brpc_tpu_torch.ops.paged_attention as pa
    rng = np.random.default_rng(seed)
    h, hkv, d, L, t = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.n_layers, page_tokens)
    need = -(-prompt_len // t) + 1
    # rows sharing one sequence's table: all of a prefill bucket, the
    # 4 draft rows of a verify group, one row per decode slot
    per = n if prefill else (4 if extra == "local_block" else 1)
    if standalone:
        pool, pages = None, []
        gen = torch.Generator(device=dev).manual_seed(seed)
        kv = torch.randn((need * (n // per), t, L, 2, hkv, d), device=dev,
                         generator=gen)
        flat = np.arange(need * (n // per), dtype=np.int32)
    else:
        pool = kvcache.PagePool(page_bytes=t * cfg.kv_bytes_per_token,
                                page_tokens=t, max_blocks=64, device=dev,
                                name="smoke_pages")
        pages = [pool.alloc_page() for _ in range(need * (n // per))]
        for p in pages:
            pool.write_raw(p, rng.standard_normal(pool.page_bytes // 4)
                           .astype(np.float32).view(np.uint8))
        flat = np.asarray(pool.flat_ids([p.pid for p in pages]), np.int32)
        kv = pa.arena_kv_view(pool.arena(), t, L, hkv, d)
    tables = np.full((n, mp), -1, np.int32)
    tables[:, :need] = np.repeat(flat.reshape(n // per, need), per, axis=0)
    if prefill:
        lengths = np.minimum(np.arange(1, n + 1, dtype=np.int32), need * t)
    else:
        lengths = (prompt_len + rng.integers(0, t, n)).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((n, h, d))
                         .astype(np.float32)).to(dev)
    kw = {}
    if extra == "self_key":
        for name in ("extra_k", "extra_v"):
            kw[name] = torch.from_numpy(rng.standard_normal((n, hkv, d))
                                        .astype(np.float32)).to(dev)
    elif extra == "local_block":
        g, w = n // 4, 4
        for name in ("local_k", "local_v"):
            kw[name] = torch.from_numpy(rng.standard_normal((g, w, hkv, d))
                                        .astype(np.float32)).to(dev)
        kw["local_mask"] = torch.from_numpy(
            np.tril(np.ones((w, w), bool))[None].repeat(g, 0)).to(dev)
    args = (q, kv[:, :, L - 1, 0], kv[:, :, L - 1, 1],
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))
    # the least work: each visible (page, token) K/V read once, q and the
    # extras read once, the output written once
    seen = {(int(tables[i, j // t]), j % t) for i in range(n)
            for j in range(int(lengths[i])) if tables[i, j // t] >= 0}
    keys = sum(sum(1 for j in range(int(lengths[i]))
                   if tables[i, j // t] >= 0) for i in range(n))
    extra_bytes = sum(x.numel() * x.element_size() for x in kw.values())
    nbytes = (len(seen) * hkv * d * 4 * 2 + 2 * q.numel() * 4
              + tables.nbytes + lengths.nbytes + extra_bytes)
    flops = 4 * keys * h * d
    return pool, pages, args, kw, nbytes, flops


def run_paged(dev, label, cfg, **shape):
    import math

    import torch
    import brpc_tpu_torch.ops.paged_attention as pa
    pool, pages, args, kw, nbytes, flops = paged_case(dev, cfg, **shape)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    # the CUDA kernels alone (split + combine, self key folded); for the
    # verify path the raw (o, m, l), without the plain-torch local fold
    kernel_kw = ({"raw": True} if "local_k" in kw else
                 {k: kw[k] for k in ("extra_k", "extra_v") if k in kw})
    try:
        out = pa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args, **kw)
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        check(err <= TOL["float32"],
              f"{label}: kernel vs plain max abs err {err}")
        ms, eager_ms = measure(lambda: pa.paged_attention(*args, **kw))
        plain_ms, eager_plain_ms = measure(
            lambda: pa.paged_attention_plain(*args, **kw))
        kernel_only_ms, _ = measure(
            lambda: pa._paged_kernel(*args, scale, **kernel_kw))
        per_call, names = launches_per_call(
            lambda: pa.paged_attention(*args, **kw))
        s_split, pps = pa.split_plan(
            args[0].shape[0], args[1].shape[2], args[3].shape[1],
            torch.cuda.get_device_properties(dev).multi_processor_count)
    finally:
        for p in pages:
            pool.unref(p)
    return {"shape": label, "dtype": "float32", "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_only_ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "eager_plain_ms": eager_plain_ms, "library_ms": None,
            "cuda_launches_per_call": per_call, "device_ops": names,
            "s_split": s_split, "pages_per_split": pps,
            "bytes": nbytes, "flops": flops,
            **bound(nbytes, flops, "float32", ms)}


# ---- kernel phase: flash attention ------------------------------------------

def run_flash(dev, label, b, s, h, hkv, d, dtype_name, causal=True):
    import torch
    import torch.nn.functional as F
    import brpc_tpu_torch.ops.attention as attn
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * s + d)
    q, k, v = [torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dev, dtype)
               for n in (h, hkv, hkv)]
    out = attn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = attn.flash_attention_plain(q, k, v, causal=causal)
    err = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
    check(err <= TOL[dtype_name], f"{label}: kernel vs plain max abs err "
                                  f"{err}")
    ms, eager_ms = measure(
        lambda: attn.flash_attention(q, k, v, causal=causal))
    plain_ms, eager_plain_ms = measure(
        lambda: attn.flash_attention_plain(q, k, v, causal=causal))
    # the library yardstick: one PyTorch call computing the same function
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if hkv == h:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - ref.float())
                    .abs().max())
    library_ms, eager_library_ms = measure(lib)
    per_call, names = launches_per_call(
        lambda: attn.flash_attention(q, k, v, causal=causal))
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    return {"shape": label, "dtype": dtype_name, "max_abs_err": err,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "eager_plain_ms": eager_plain_ms, "library_ms": library_ms,
            "eager_library_ms": eager_library_ms,
            "library_max_abs_err": lib_err, "library_ratio": ms / library_ms,
            "cuda_launches_per_call": per_call, "device_ops": names,
            "bytes": nbytes, "flops": flops,
            **bound(nbytes, flops, dtype_name, ms)}


def sass_counts(kbuild):
    """Tensor-core (HMMA), async-copy (LDGSTS) and ldmatrix (LDSM)
    instructions in each built kernel library, by ``cuobjdump -sass``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = {}
    for name, lib in kbuild.build().items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        out[name] = {op: sum(1 for ln in sass.splitlines() if op in ln)
                     for op in ("HMMA", "LDGSTS", "LDSM")}
    return out


# ---- serving phase ----------------------------------------------------------

def profile_window(fn):
    """Run ``fn`` under ``torch.profiler`` and return the device's busy
    share of the window's wall time and its top kernels by device time
    (the profiler's own host cost inflates the wall time a little).
    Returns ``(result of fn, summary)``; the summary says "not measured"
    where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    if not busy_us:
        return out, {"wall_s": wall, "device_busy_share": "not measured"}
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return out, {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in top]}


def serve(dev, label, cfg, *, page_tokens, num_slots, max_pages,
          max_blocks, prompt_len, buckets, seed):
    """8 concurrent requests, cold then warm, through the port's engine;
    every stream equal to dense_generate on the card."""
    import torch
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.ops.attention as attn
    import brpc_tpu_torch.ops.paged_attention as pa
    import brpc_tpu_torch.serving as serving
    params = models.init_runner_params(cfg, seed, device=dev)
    store = models.make_store_for(cfg, page_tokens=page_tokens,
                                  max_blocks=max_blocks, device=dev,
                                  name=label)
    bpool = store.pagepool.pool
    free0 = bpool.stats()["classes"]
    runner = models.TransformerRunner(params, cfg, store=store, device=dev,
                                      name=label)
    engine = serving.DecodeEngine(
        runner=runner, store=store, num_slots=num_slots,
        max_pages_per_slot=max_pages, prefill_buckets=buckets, device=dev,
        name=label)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).tolist()
               for _ in range(N_REQUESTS)]

    def run_all():
        recs = []
        for p in prompts:
            rec = {"toks": [], "errs": [], "ev": threading.Event()}
            engine.submit(p, NEW_TOKENS, rec["toks"].append,
                          lambda e, r=rec: (r["errs"].append(e),
                                            r["ev"].set()))
            recs.append(rec)
        for rec in recs:
            check(rec["ev"].wait(300), f"{label}: a generation hung")
            check(rec["errs"] == [None], f"{label}: {rec['errs']}")
        return [rec["toks"] for rec in recs]

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        pa.paged_attention.launches = 0
        pa.paged_attention.cuda_launches = 0
        attn.flash_attention.launches = 0
        t0 = time.perf_counter()
        cold = run_all()
        t_cold = time.perf_counter() - t0
        steps_cold = engine.steps
        step_s_cold = engine.step_seconds
        hit0 = store.hit_tokens
        t0 = time.perf_counter()
        warm = run_all()
        t_warm = time.perf_counter() - t0
        hit = store.hit_tokens - hit0
        paged_serving = pa.paged_attention.launches
        paged_cuda_serving = pa.paged_attention.cuda_launches
        t0 = time.perf_counter()
        oracle = [models.dense_generate(params, cfg, p, NEW_TOKENS,
                                        device=dev) for p in prompts]
        t_oracle = time.perf_counter() - t0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": attn.flash_attention.launches}
        # device memory allocated at the peak, and how much of it this
        # run added to what was allocated when it started (weights and
        # the block pool's class tensors may predate it)
        peak = torch.cuda.max_memory_allocated(dev)
        peak_added = peak - mem0
        for i, (c, o) in enumerate(zip(cold, oracle)):
            check(c == o, f"{label}: request {i} streamed {c}, dense "
                          f"oracle {o}")
        check(warm == cold, f"{label}: warm streams differ from cold")
        check(hit > 0, f"{label}: the warm pass hit no cached prefix")
        check(launches["paged_attention"] > 0 and
              launches["flash_attention"] > 0,
              f"{label}: a kernel was not launched on the path: {launches}")
        logits = models.dense_forward(
            params, cfg, torch.tensor([prompts[0]], device=dev),
            torch.arange(prompt_len, device=dev)[None])
        check(tuple(logits.shape) == (1, prompt_len, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{label}: dense logits malformed")
        st = engine.stats()
        # one more warm pass under the profiler: where the device time
        # goes and how much of the wall time the device is busy
        again, prof = profile_window(run_all)
        check(again == cold, f"{label}: profiled pass streams differ")
    finally:
        engine.close()
        store.clear()
    check(store.pagepool.blocks_leased() == 0 and
          bpool.stats()["classes"] == free0,
          f"{label}: the page pool did not return to its baseline")
    toks = N_REQUESTS * NEW_TOKENS
    return {
        "config": label, "cfg": cfg.__dict__,
        "page_tokens": page_tokens, "num_slots": num_slots,
        "requests": N_REQUESTS, "prompt_len": prompt_len,
        "new_tokens": NEW_TOKENS,
        "cold_s": t_cold, "warm_s": t_warm, "oracle_s": t_oracle,
        "cold_tokens_per_s": toks / t_cold, "warm_tokens_per_s": toks / t_warm,
        "mean_step_ms": 1e3 * st["step_seconds"] / max(1, st["steps"]),
        "mean_step_ms_cold": 1e3 * step_s_cold / max(1, steps_cold),
        "steps": st["steps"], "warm_prefix_hit_tokens": hit,
        "peak_memory_bytes": peak, "peak_memory_added_bytes": peak_added,
        "launches": launches,
        "paged_launches_engine": paged_serving,
        "paged_cuda_launches_engine": paged_cuda_serving,
        "warm_profile": prof,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "brpc_tpu_torch")):
        print("chip_smoke: run from a checkout (brpc_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.ops._build as kbuild
    import brpc_tpu_torch.ops.attention as attn
    import brpc_tpu_torch.ops.paged_attention as pa
    t0 = time.perf_counter()
    kbuild.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in kbuild.SOURCES:
        log = kbuild.log_path(name)
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s  {json.dumps(ptxas)}", flush=True)
    sass = sass_counts(kbuild)
    print(f"sass: {json.dumps(sass)}", flush=True)
    check(sass["flash_attention"]["HMMA"] > 0,
          "the flash kernel's SASS has no tensor-core (HMMA) instruction")

    cfg_a = models.TransformerConfig()
    cfg_b = models.TransformerConfig(vocab=32768, d_model=1024, n_layers=8,
                                     n_heads=8, n_kv_heads=4, head_dim=128,
                                     d_ff=4096)
    # -- kernel phase, at the serving path's shapes
    paged = [
        run_paged(dev, "a decode N4 MP32 T4 +self", cfg_a, page_tokens=4,
                  n=4, mp=32, prefill=False, extra="self_key", seed=1,
                  prompt_len=80),
        run_paged(dev, "a prefill N64 MP32 T4", cfg_a, page_tokens=4, n=64,
                  mp=32, prefill=True, extra="none", seed=2, prompt_len=64),
        run_paged(dev, "b decode N8 MP16 T16 +self", cfg_b, page_tokens=16,
                  n=8, mp=16, prefill=False, extra="self_key", seed=3,
                  prompt_len=216),
        run_paged(dev, "b prefill N256 MP16 T16", cfg_b, page_tokens=16,
                  n=256, mp=16, prefill=True, extra="none", seed=4,
                  prompt_len=200),
        run_paged(dev, "b verify N32 MP16 T16 +local", cfg_b,
                  page_tokens=16, n=32, mp=16, prefill=False,
                  extra="local_block", seed=5, prompt_len=200),
        # a long context: split-K spreads 128 page entries over the SMs
        run_paged(dev, "b decode N8 MP128 T16 +self (~2048 keys)", cfg_b,
                  page_tokens=16, n=8, mp=128, prefill=False,
                  extra="self_key", seed=6, prompt_len=2016,
                  standalone=True),
    ]
    flash = [
        run_flash(dev, "a oracle B1 S95 H4/2 D8", 1, 95, 4, 2, 8, "float32"),
        run_flash(dev, "b oracle B1 S231 H8/4 D128", 1, 231, 8, 4, 128,
                  "float32"),
        run_flash(dev, "bench B4 S4096 H8 D128 f32", 4, 4096, 8, 8, 128,
                  "float32"),
        run_flash(dev, "bench B4 S4096 H8 D128 bf16", 4, 4096, 8, 8, 128,
                  "bfloat16"),
    ]
    for row in paged + flash:
        konly = (f" kernel-only {row['kernel_only_ms']:.4f}"
                 if "kernel_only_ms" in row else "")
        print(f"kernel {row['shape']}: err {row['max_abs_err']:.3g} "
              f"device ms {row['ms']:.4f}{konly} (eager "
              f"{row['eager_ms']:.4f}) plain {row['plain_ms']:.4f} library "
              f"{row['library_ms']} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row['bound_rate']}) achieved "
              f"{row['achieved']}, {100 * row['share_of_bound']:.1f}% of "
              f"bound, {row['cuda_launches_per_call']} CUDA launches/call",
              flush=True)

    # -- serving phase, twice
    served = [
        serve(dev, "a", cfg_a, page_tokens=4, num_slots=4, max_pages=32,
              max_blocks=32, prompt_len=64, buckets=(16, 64, 256), seed=11),
        serve(dev, "b", cfg_b, page_tokens=16, num_slots=8, max_pages=16,
              max_blocks=64, prompt_len=200, buckets=(16, 64, 256),
              seed=12),
    ]
    for r in served:
        print(f"serve {r['config']}: cold {r['cold_tokens_per_s']:.1f} tok/s"
              f" warm {r['warm_tokens_per_s']:.1f} tok/s, mean step "
              f"{r['mean_step_ms']:.3f} ms, peak "
              f"{r['peak_memory_bytes'] / 2**20:.1f} MiB (+"
              f"{r['peak_memory_added_bytes'] / 2**20:.1f}), warm hit "
              f"{r['warm_prefix_hit_tokens']} tokens, launches "
              f"{r['launches']}, device busy (profiled warm pass) "
              f"{r['warm_profile']['device_busy_share']}", flush=True)

    def entry(name, source, replaces, rows, main_row):
        m = rows[main_row]
        err = max(r["max_abs_err"] for r in rows)
        launches = sum(r["launches"][name] for r in served)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "max_abs_diff": err,
                "ms": m["ms"], "kernel_ms": m["ms"],
                "eager_ms": m["eager_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "bound_rate": m["bound_rate"],
                "achieved": m["achieved"],
                "share_of_bound": m["share_of_bound"],
                "cuda_launches_per_call": m["cuda_launches_per_call"],
                "library_ms": m["library_ms"], "sass": sass[name],
                "at": m["shape"], "shapes": rows}

    kernels = [
        entry("paged_attention", "brpc_tpu_torch/csrc/paged_attention.cu",
              "brpc_tpu/ops/paged_attention.py:178", paged, 2),
        entry("flash_attention", "brpc_tpu_torch/csrc/flash_attention.cu",
              "brpc_tpu/ops/attention.py:82", flash, 1),
    ]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "sass": sass, "kernels": kernels,
              "serving": served,
              "launch_counts_now": {
                  "paged_attention": pa.paged_attention.launches,
                  "flash_attention": attn.flash_attention.launches}}
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
