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
     context; its verify rows with the local draft block, chains and the
     engine's draft trees with padded rows) and holds it against its
     plain PyTorch version (f32 atol 1e-4, bf16 2e-2; the paged kernel
     against both the split-K plain version at the kernel's own split
     plan and the gather plain version, at 2 CUDA launches per call),
     timing kernel, plain version and -- for flash
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
  5. speculative serving phase: the wide configuration's prompts and
     dense oracle again through a speculative ``DecodeEngine``
     (draft_len 4), once with ``NGramProposer`` and once with a width-2
     ``DraftModelProposer`` over the target's own weights (the flash
     kernel on every proposal, the side branch on a fork): every stream
     equal to the oracle cold and warm, drafts accepted, every verify
     call at 2 CUDA launches of the paged kernel per layer, no live
     sequence and the page pool at its baseline after each run; tokens
     per verify > 1, forks > 0 and flash launches > 0 for the draft
     model; printed beside the plain run's numbers;
  6. RPC serving phase: the wide configuration behind
     ``Serving.Generate`` on the port's own ``Server`` (127.0.0.1:0, the
     native host core built from ``src/cc`` with ``g++`` into
     ``build/torch_core/`` while ``nvcc`` builds the kernels): 8
     concurrent 32-token streams through the port's ``Channel``, cold
     (prefix_hit 0) and warm (prefix_hit > 0, identical tokens), warm
     again from a client in its own process (the script waits for it to
     exit), 10 pairs of warm passes on the same engine over RPC and
     direct in alternating order (tokens/s and mean step of each), then
     the same prompts through an ``NGramProposer`` speculative engine
     behind its own ``Serving`` service with one request sending
     ``"speculative": false``; every stream equal to the port's
     ``dense_generate`` on the card, no live sequence and the pool at
     its baseline after each engine shuts down (server, engine, store),
     the paged kernel launched in the phase; prints tokens/s over RPC
     beside the direct engine's (the pairs' medians and RPC/direct
     quartiles), the client-timed time to first token (p50, max) and
     inter-token gap (p50, p99), the native build's seconds and the
     phase's paged-kernel launches, with the card's name and power
     limit;
  7. control-plane phase, the wide configuration again, the plain run's
     weights, prompts and dense oracle: one port ``Server`` with
     ``register_serving(batcher=DynamicBatcher(runner), engine=
     EngineSupervisor(...))``.  Score: 32 concurrent ``ScoreT`` calls
     (tensorframe, through ``ScoreClient``) and 8 json ``Score`` calls
     over the prompts, through the batcher (max batch 8, length buckets
     64/256) into ``TransformerRunner.score`` -- the flash kernel once
     per layer per batch -- every row's ids equal to the argmax of an
     unbatched ``dense_forward`` of that row on the card, its last id
     the oracle's first token.  Supervised Generate: 8 concurrent
     32-token streams over RPC with one ``serving.step`` crash injected
     (the port's ``fault.FaultPlan``), the engine rebuilt on the same
     store and every stream resumed exactly once from its pinned prefix
     (restarts 1, re-admissions hitting the detached pages), then an
     uncrashed pass on the same supervisor; then Score again through a
     prefix-cached batcher (``score_with_offsets`` over the warm store:
     each row its uncached suffix, held to the unbatched forward of that
     suffix at its offsets; prefix skip > 0); brownout: with the
     supervisor's level floor at 1 a deadline-less Score is shed with
     ELIMIT, a deadlined one served; last, an NGram speculative engine
     under its own supervisor and server, crashed once through
     ``serving.spec_verify``.  Every stream equal to the oracle, every
     paged call at 2 CUDA launches, the pool at its baseline after each
     close.  Prints rows/s, batch size, pad waste, queue delay p50/p99,
     client-timed latency per wire, detect-to-rebuild and
     crash-to-first-resumed-token times, tokens/s of the crashed pass
     beside the uncrashed one, and the phase's launches;
  8. host-path phase, the wide configuration, the plain run's weights,
     prompts and oracle, one ``EngineSupervisor`` behind one ``Server``:
     the native hot path (``native_hot_path_enabled``: native emit rings,
     one ``brpc_tokring_push_many`` per step, native page-table fill and
     batch pad, the native span queue) on and off in alternating pairs,
     direct (in-process submits) and over RPC (tokens/s and mean step
     of each pass, per-stage host CPU per token from ``hostcpu``);
     Score (16 ScoreT rows a pass, a fresh batcher each) with the flag on
     and off (rows/s, the batcher's batch-time EMA); rpcz on: one traced
     Generate (client -> server -> generation -> decode with its KV
     annotations -> prefill, one trace) and one traced Score (its batch
     span's queue delay), passes with rpcz on and off, and a supervised
     pass with a ``serving.step`` crash whose every stream's two
     attempts share its trace (``recovered_from``); the top 5 locks by
     wait time, no lock-order violation (the witness); every stream the
     oracle's, every row the unbatched forward's;
  9. replicas phase, the wide configuration's weights on two replicas
     R0 and R1, each with its own runner, ``KVCacheStore``,
     ``EngineSupervisor(endpoint=..., quarantine_after=3)``,
     ``DynamicBatcher`` and port ``Server``, behind the port's cluster
     channel ``Channel("list://R0,R1", load_balancer="prefix_affinity")``
     with each request's code its prompt's ``prefix_fingerprint``: 4
     prefix families of 4 200-token prompts (a 160-token head each), 32
     new tokens, 8 streams at a time.  First Score: 16 ``ScoreT`` rows a
     pass fanned out over both replicas by a ``ParallelChannel`` (a
     ``CallMapper`` gives each replica half, a merger restores the
     order) against all 16 on R0, in 3 alternating pairs, then through
     ``PartitionChannel.call_partitioned``; then a backup request: R0's
     batch stalled 0.2 s (``fault.BATCH``), a Score on an ``rr``
     cluster channel with ``backup_request_ms=20`` answered by R1.
     Generate cold and warm: each family on its ring owner, warm hits of
     at least 144 tokens on the owner and none on the other replica.
     Quarantine: R0's engine crash-loops (``fault.STEP`` x3) with its
     families in flight, the supervisor marks R0 broken, a wave issued
     then puts every family on R1; the health probe (every 50 ms)
     revives R0 after the breaker's hold; 3 alternating warm pairs of
     the cluster against R0 alone through a plain ``Channel``; after the
     breaker's 3 s re-admission ramp, R0's families route back to R0.
     Every stream equal to the dense oracle, every row to the unbatched
     forward; prints tokens/s, hits per replica, crash -> quarantine,
     -> first token on the survivor and -> revival times, Score rows/s,
     backups and the phase's launches;
 10. after every serving phase, no native emit ring alive beyond the
     baseline (``native_path.tokring_live``); prints ``{"kernels":
     [...]}``, the card line, and as the LAST line
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
RPC_PAIRS = 6        # warm passes over RPC and direct, in alternating order
HOST_PAIRS = 6       # native hot path on/off pairs, direct and over RPC
SCORE_PAIRS = 3      # Score passes with the native hot path on and off
TRACE_PAIRS = 3      # passes with rpcz on and off
SCORE_T_CALLS = 32   # concurrent ScoreT calls of the control-plane phase
SCORE_JSON_CALLS = 8
# the replicas phase: prefix families over two replicas
REPLICA_FAMILIES = 4
FAMILY_SIZE = 4
FAMILY_HEAD = 160    # tokens a family shares
FAMILY_TAIL = 40     # tokens of each prompt's own
REPLICA_PAIRS = 3    # warm cluster/one-replica Generate pairs
SCORE_FAN_PAIRS = 3  # fanned-out/one-replica Score pairs
# ladder thresholds no burst of the control-plane phase can cross: its
# brownout is driven by the level floor alone
CALM_LADDER = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
                "queue_depth": 1e9},) * 3


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


def launches_per_call(fn, tries=3):
    """CUDA kernels (and copies) one call of ``fn`` puts on the device,
    counted by ``torch.profiler`` over one warm call; "not measured"
    where the profiler saw no device activity.  The profiler has been
    seen to miss the first kernel of its window on the card, so each
    window opens with a marker (an int8 fill, which no wrapper here
    issues), dropped by position: only an event in the window's first
    place that carries the marker's name.  The count must be the same
    in at least 2 of ``tries`` windows; otherwise the counts of every
    window are returned, which no launch check accepts."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, dtype=torch.int8, device="cuda")

    def device_names(body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        return [e.name for e in evs]

    fn()
    torch.cuda.synchronize()
    # twice: the marker's name is learned even if the first is missed
    marker_name = device_names(lambda: (marker.fill_(1),
                                        marker.fill_(1)))[-1:]
    windows = []
    for _ in range(tries):
        names = device_names(lambda: (marker.fill_(1), fn()))
        if names[:1] == marker_name:
            names = names[1:]
        windows.append(names)
    count, seen = collections.Counter(len(w) for w in windows
                                      ).most_common(1)[0]
    if seen < 2:
        return [len(w) for w in windows], windows
    names = next(w for w in windows if len(w) == count)
    return (count, names) if names else ("not measured", [])


# ---- kernel phase: paged attention -----------------------------------------

# The verify groups of the engine's draft tree at draft_len 4 under a
# width-2 draft model: the root (the last token), branch 0 (rows 1, 2) and
# branch 1 (rows 3, 4), each row seeing the root, its branch's earlier
# rows and itself; then slots with less: a chain of two, no draft, and an
# empty slot.  Padded rows see nothing (no page entry, no local key).
TREE_GROUPS = (
    [[0], [0, 1], [0, 1, 2], [0, 3], [0, 3, 4]],
    [[0], [0, 1], [0, 1, 2], None, None],
    [[0], None, None, None, None],
    [None] * 5,
)


def local_masks(g, w, tree):
    """[g, w, w] ancestry masks: lower-triangular chains, or the engine's
    tree groups (TREE_GROUPS, cycled).  Returns the masks and, per row,
    whether it is a real (unpadded) row."""
    if not tree:
        return (np.tril(np.ones((w, w), bool))[None].repeat(g, 0),
                np.ones(g * w, bool))
    mask = np.zeros((g, w, w), bool)
    for gi in range(g):
        for r, vis in enumerate(TREE_GROUPS[gi % len(TREE_GROUPS)]):
            if vis is not None:
                mask[gi, r, vis] = True
    return mask, mask.any(axis=2).reshape(-1)


def paged_case(dev, cfg, *, page_tokens, n, mp, prefill, extra, seed,
               prompt_len, standalone=False, w=4, tree=False):
    """Inputs shaped as the serving path gives them to the paged kernel:
    the last layer's K/V slices of a real PagePool arena, decode rows
    with their own tables at ~prompt_len keys, one prefill bucket of
    causal rows over one table, or verify groups of ``w`` rows sharing a
    table with a local key block (chains, or with ``tree`` the engine's
    draft trees with padded rows).  ``standalone``: an arena tensor of
    the same layout allocated here, for more pages than a pool's block
    class holds (the long-context row)."""
    import torch
    import brpc_tpu_torch.kvcache as kvcache
    import brpc_tpu_torch.ops.paged_attention as pa
    rng = np.random.default_rng(seed)
    h, hkv, d, L, t = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.n_layers, page_tokens)
    need = -(-prompt_len // t) + 1
    # rows sharing one sequence's table: all of a prefill bucket, the
    # w rows of a verify group, one row per decode slot
    per = n if prefill else (w if extra == "local_block" else 1)
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
    elif extra == "local_block":
        # a group's rows share the slot's materialised length
        lengths = np.repeat(prompt_len + rng.integers(0, t, n // w),
                            w).astype(np.int32)
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
        g = n // w
        mask, real = local_masks(g, w, tree)
        tables[~real] = -1
        lengths[~real] = 0
        # K and V rows of one projection output, as strided views
        kvrows = torch.from_numpy(rng.standard_normal((g, w, 2, hkv, d))
                                  .astype(np.float32)).to(dev)
        kw["local_k"], kw["local_v"] = kvrows[:, :, 0], kvrows[:, :, 1]
        kw["local_mask"] = torch.from_numpy(mask).to(dev)
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
    if "local_mask" in kw:
        keys += int(kw["local_mask"].sum())
    nbytes = (len(seen) * hkv * d * 4 * 2 + 2 * q.numel() * 4
              + tables.nbytes + lengths.nbytes + extra_bytes)
    flops = 4 * keys * h * d
    return pool, pages, args, kw, nbytes, flops


def run_paged(dev, label, cfg, **shape):
    import torch
    import brpc_tpu_torch.ops.paged_attention as pa
    pool, pages, args, kw, nbytes, flops = paged_case(dev, cfg, **shape)
    try:
        s_split, pps = pa.split_plan(
            args[0].shape[0], args[1].shape[2], args[3].shape[1],
            torch.cuda.get_device_properties(dev).multi_processor_count)
        out = pa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        # the kernels' own arithmetic (the same ranges, the combine's
        # order), and the independent gather + softmax version
        ref = pa.paged_attention_split_plain(*args, **kw, s_split=s_split)
        err = float((out - ref).abs().max())
        err_gather = float(
            (out - pa.paged_attention_plain(*args, **kw)).abs().max())
        check(max(err, err_gather) <= TOL["float32"],
              f"{label}: kernel vs plain max abs err {err} (split-K plain)"
              f", {err_gather} (gather plain)")
        ms, eager_ms = measure(lambda: pa.paged_attention(*args, **kw))
        plain_ms, eager_plain_ms = measure(
            lambda: pa.paged_attention_plain(*args, **kw))
        per_call, names = launches_per_call(
            lambda: pa.paged_attention(*args, **kw))
        check(per_call == 2, f"{label}: {per_call} CUDA launches per call "
                             f"({names}), not 2")
    finally:
        for p in pages:
            pool.unref(p)
    return {"shape": label, "dtype": "float32", "max_abs_err": err,
            "max_abs_err_gather_plain": err_gather, "ms": ms,
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


def generate_all(engine, prompts, label):
    """Submit every prompt at once; wait for every stream.  Returns the
    streams; any error or a hang fails the run."""
    recs = []
    for p in prompts:
        rec = {"toks": [], "errs": [], "ev": threading.Event()}
        engine.submit(p, NEW_TOKENS, rec["toks"].append,
                      lambda e, r=rec: (r["errs"].append(e), r["ev"].set()))
        recs.append(rec)
    for rec in recs:
        check(rec["ev"].wait(300), f"{label}: a generation hung")
        check(rec["errs"] == [None], f"{label}: {rec['errs']}")
    return [rec["toks"] for rec in recs]


def serve(dev, label, cfg, *, page_tokens, num_slots, max_pages,
          max_blocks, prompt_len, buckets, seed):
    """8 concurrent requests, cold then warm, through the port's engine;
    every stream equal to dense_generate on the card.  Returns the
    record and, for the speculative runs, the parameters, prompts and
    oracle streams."""
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
        return generate_all(engine, prompts, label)

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
        steps_cold = engine.steps.get_value()
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
    ctx = {"params": params, "prompts": prompts, "oracle": oracle,
           "geometry": {"page_tokens": page_tokens, "num_slots": num_slots,
                        "max_pages": max_pages, "max_blocks": max_blocks,
                        "buckets": buckets}}
    return ctx, {
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


def serve_spec(dev, label, cfg, ctx, proposer, draft_len):
    """The plain run's prompts through a speculative engine (``proposer``
    drafts, ``draft_len`` rows per slot), cold then warm, every stream
    equal to the plain run's dense oracle; the verify calls reach the
    paged kernels at 2 CUDA launches each; no sequence and no page is
    left behind."""
    import torch
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.ops.attention as attn
    import brpc_tpu_torch.ops.paged_attention as pa
    import brpc_tpu_torch.serving as serving
    geo = ctx["geometry"]
    prompts, oracle = ctx["prompts"], ctx["oracle"]
    store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                  max_blocks=geo["max_blocks"], device=dev,
                                  name=label)
    bpool = store.pagepool.pool
    free0 = bpool.stats()["classes"]
    runner = models.TransformerRunner(ctx["params"], cfg, store=store,
                                      device=dev, name=label)
    engine = serving.DecodeEngine(
        runner=runner, store=store, num_slots=geo["num_slots"],
        max_pages_per_slot=geo["max_pages"],
        prefill_buckets=geo["buckets"], draft_runner=proposer,
        draft_len=draft_len, device=dev, name=label)
    try:
        torch.cuda.synchronize()
        pa.paged_attention.launches = 0
        pa.paged_attention.cuda_launches = 0
        attn.flash_attention.launches = 0
        t0 = time.perf_counter()
        cold = generate_all(engine, prompts, label)
        t_cold = time.perf_counter() - t0
        hit0 = store.hit_tokens
        t0 = time.perf_counter()
        warm = generate_all(engine, prompts, label)
        t_warm = time.perf_counter() - t0
        hit = store.hit_tokens - hit0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": attn.flash_attention.launches}
        paged_cuda = pa.paged_attention.cuda_launches
        check(engine.join_idle(30), f"{label}: the engine did not go idle")
        st = engine.stats()
        sp = st["speculative"]
        live = store.stats()["live_seqs"]
        forks = store.stats()["forks"]
        for i, (c, o) in enumerate(zip(cold, oracle)):
            check(c == o, f"{label}: request {i} streamed {c}, dense "
                          f"oracle {o}")
        check(warm == cold, f"{label}: warm streams differ from cold")
        check(hit > 0, f"{label}: the warm pass hit no cached prefix")
        check(sp["spec_accepted"] > 0, f"{label}: no draft was accepted")
        check(live == 0, f"{label}: {live} sequences still live")
        # every verify call is n_layers paged calls of 2 CUDA launches
        check(sp["verify_calls"] > 0 and launches["paged_attention"]
              >= sp["verify_calls"] * cfg.n_layers
              and paged_cuda == 2 * launches["paged_attention"],
              f"{label}: {sp['verify_calls']} verify calls, "
              f"{launches['paged_attention']} paged calls, {paged_cuda} "
              f"CUDA launches")
        again, prof = profile_window(
            lambda: generate_all(engine, prompts, label))
        check(again == cold, f"{label}: profiled pass streams differ")
    finally:
        engine.close()
        store.clear()
    check(store.pagepool.blocks_leased() == 0 and
          bpool.stats()["classes"] == free0,
          f"{label}: the page pool did not return to its baseline")
    toks = N_REQUESTS * NEW_TOKENS
    return {
        "config": label, "proposer": sp["proposer"], "draft_len": draft_len,
        "cold_s": t_cold, "warm_s": t_warm,
        "cold_tokens_per_s": toks / t_cold, "warm_tokens_per_s": toks / t_warm,
        "mean_step_ms": 1e3 * st["step_seconds"] / max(1, st["steps"]),
        "mean_verify_ms": 1e3 * sp["verify_seconds"]
        / max(1, sp["verify_calls"]),
        "mean_propose_ms": 1e3 * sp["propose_seconds"]
        / max(1, sp["verify_calls"]),
        "steps": st["steps"], "verify_calls": sp["verify_calls"],
        "accept_rate": sp["accept_rate"],
        "tokens_per_verify": sp["tokens_per_verify"],
        "spec": sp, "forks": forks, "warm_prefix_hit_tokens": hit,
        "launches": launches, "paged_cuda_launches": paged_cuda,
        "warm_profile": prof,
    }


# ---- RPC serving phase ------------------------------------------------------

def pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) \
        if len(xs) else None


def issue_generates(ch, prompts, extra=None, roots=None, codes=None):
    """One ``Serving.Generate`` per prompt, all issued at once on channel
    ``ch``, each with its own token stream; the client stamps each
    call's issue and each token's arrival.  With ``roots`` (a list),
    each call is issued under a fresh rpcz client span, which is
    appended to it; with ``codes``, each call carries its request code
    (a cluster channel's balancer routes by it).  Returns the calls'
    records for :func:`wait_generates`."""
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.rpcz as rpcz

    class Stream(rpc.StreamHandler):
        def __init__(self):
            self.toks, self.arrivals, self.terminal = [], [], None
            self.closed = threading.Event()
            self.answered = threading.Event()
            self.resp = self.err = None
            self.side = ""

        def on_received_messages(self, stream, messages):
            now = time.perf_counter()
            for m in messages:
                d = json.loads(m)
                if "token" in d:
                    self.toks.append(d["token"])
                    self.arrivals.append(now)
                elif d.get("done"):
                    self.terminal = d

        def on_closed(self, stream):
            self.closed.set()

        def on_response(self, cntl):
            self.resp, self.err = cntl.response, cntl.error_code
            self.side = cntl.remote_side
            self.answered.set()

    recs = []
    for i, p in enumerate(prompts):
        rec, cntl = Stream(), rpc.Controller()
        if codes is not None:
            cntl.request_code = codes[i]
        rpc.stream_create(cntl, rec)
        body = {"prompt": p, "max_new_tokens": NEW_TOKENS,
                **((extra or {}).get(i, {}))}
        rec.t_issue = time.perf_counter()
        if roots is not None:
            roots.append(rpcz.new_span("client", "Serving", "Generate"))
            rpcz.set_current_span(roots[-1])
        try:
            ch.call("Serving", "Generate", body, cntl=cntl,
                    done=rec.on_response, serializer="json")
        finally:
            if roots is not None:
                rpcz.set_current_span(None)
        recs.append(rec)
    return recs


def wait_generates(recs, label):
    """Wait for every stream of :func:`issue_generates`; any error or a
    hang fails the run.  Returns the streams, their ``prefix_hit``s, the
    client-timed time to first token and inter-token gaps (seconds), and
    the server each call went to."""
    for i, rec in enumerate(recs):
        check(rec.answered.wait(300) and rec.closed.wait(300),
              f"{label}: stream {i} hung")
        check(rec.err == 0 and rec.resp.get("accepted") is True,
              f"{label}: stream {i} answered {rec.err} {rec.resp}")
        check(rec.terminal == {"done": True},
              f"{label}: stream {i} ended with {rec.terminal}")
    ttft = [r.arrivals[0] - r.t_issue for r in recs if r.arrivals]
    gaps = [b - a for r in recs for a, b in zip(r.arrivals, r.arrivals[1:])]
    return ([r.toks for r in recs], [r.resp["prefix_hit"] for r in recs],
            ttft, gaps, [r.side for r in recs])


def rpc_generate_all(port, prompts, label, extra=None, roots=None):
    """One ``Serving.Generate`` per prompt, all issued at once through
    the port's Channel to ``port`` (see :func:`issue_generates`).
    Returns the streams, their ``prefix_hit``s, the client-timed time to
    first token and inter-token gaps (seconds), and the wall time."""
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.rpcz as rpcz
    ch = rpc.Channel(f"127.0.0.1:{port}", timeout_ms=120_000)
    t0 = time.perf_counter()
    recs = issue_generates(ch, prompts, extra, roots)
    streams, hits, ttft, gaps, _ = wait_generates(recs, label)
    wall = time.perf_counter() - t0
    for root in roots or ():
        rpcz.submit(root)
    return streams, hits, ttft, gaps, wall


_CLIENT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
out = cs.rpc_generate_all(int(sys.argv[2]), json.load(sys.stdin),
                          "b rpc warm, client process")
print(json.dumps(out))
"""


def rpc_generate_in_child(port, prompts):
    """``rpc_generate_all`` from a client in its own process, so the
    server process holds only the server's work (an in-process client's
    stream handlers compete for the server's interpreter lock).  The
    child is waited for and has exited when this returns."""
    proc = subprocess.run([sys.executable, "-c", _CLIENT, ROOT, str(port)],
                          input=json.dumps(prompts), capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"b rpc client process failed "
                                f"({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def serve_rpc(dev, cfg, ctx, card):
    """The wide configuration behind ``Serving.Generate`` on the port's
    Server (127.0.0.1:0): 8 concurrent 32-token streams through the
    port's Channel cold, then warm, then warm from a client process,
    then paired warm passes over RPC and direct on the same engine,
    alternating which runs first; then the same prompts through an
    NGramProposer speculative engine behind another Serving service, one
    request sending ``"speculative": false``.  Every stream equals the
    port's ``dense_generate`` on the card (the plain (b) run's oracle);
    no live sequence and the pool at its baseline after each engine's
    run."""
    import torch
    import brpc_tpu_torch._core.build as cbuild
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.ops.attention as attn
    import brpc_tpu_torch.ops.paged_attention as pa
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    import brpc_tpu_torch.serving.speculative as spec
    geo, prompts = ctx["geometry"], ctx["prompts"]
    toks = N_REQUESTS * NEW_TOKENS

    def make(label, **kw):
        store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                      max_blocks=geo["max_blocks"],
                                      device=dev, name=label)
        runner = models.TransformerRunner(ctx["params"], cfg, store=store,
                                          device=dev, name=label)
        engine = serving.DecodeEngine(
            runner=runner, store=store, num_slots=geo["num_slots"],
            max_pages_per_slot=geo["max_pages"],
            prefill_buckets=geo["buckets"], device=dev, name=label, **kw)
        return store, store.pagepool.pool.stats()["classes"], engine

    def shut(label, server, engine, store, free0):
        # the order: server, engine, store
        check(engine.join_idle(30), f"{label}: the engine did not go idle")
        live = store.stats()["live_seqs"]
        check(live == 0, f"{label}: {live} sequences still live")
        server.stop()
        server.join()
        engine.close()
        store.clear()
        check(store.pagepool.blocks_leased() == 0 and
              store.pagepool.pool.stats()["classes"] == free0,
              f"{label}: the page pool did not return to its baseline")

    class Recording:
        """The engine as the service sees it, recording each submit's
        keywords (the forwarded opt-out)."""

        def __init__(self, engine):
            self.engine, self.store, self.kws = engine, engine.store, []

        def submit(self, *a, **kw):
            self.kws.append(kw)
            return self.engine.submit(*a, **kw)

    torch.cuda.synchronize()
    pa.paged_attention.launches = 0
    pa.paged_attention.cuda_launches = 0
    attn.flash_attention.launches = 0
    store, free0, engine = make("b rpc")
    server = rpc.Server()
    serving.register_serving(server, engine=engine)
    server.start("127.0.0.1", 0)
    try:
        cold, hit_cold, ttft_c, gaps_c, t_cold = rpc_generate_all(
            server.port, prompts, "b rpc cold")
        warm, hit_warm, ttft_w, gaps_w, t_warm = rpc_generate_all(
            server.port, prompts, "b rpc warm")
        child, hit_child, ttft_p, gaps_p, t_child = rpc_generate_in_child(
            server.port, prompts)
        # paired warm passes on this engine, RPC and direct, alternating
        # which runs first: tokens/s and the mean step of each pass
        paired = {"rpc": [], "direct": []}
        for i in range(RPC_PAIRS):
            for kind in ("rpc", "direct") if i % 2 else ("direct", "rpc"):
                steps0, sec0 = engine.steps.get_value(), engine.step_seconds
                t0 = time.perf_counter()
                if kind == "rpc":
                    streams = rpc_generate_all(server.port, prompts,
                                               "b rpc pair")[0]
                else:
                    streams = generate_all(engine, prompts, "b rpc direct")
                t = time.perf_counter() - t0
                paired[kind].append(
                    (streams, toks / t, 1e3 * (engine.step_seconds - sec0)
                     / max(1, engine.steps.get_value() - steps0)))
    finally:
        shut("b rpc", server, engine, store, free0)
    # the speculative engine behind its own Serving service
    store, free0, engine = make("b rpc spec",
                                draft_runner=spec.NGramProposer(),
                                draft_len=4)
    rec = Recording(engine)
    server = rpc.Server()
    serving.register_serving(server, engine=rec)
    server.start("127.0.0.1", 0)
    try:
        spec_out, _, ttft_s, gaps_s, t_spec = rpc_generate_all(
            server.port, prompts, "b rpc spec", extra={3: {
                "speculative": False}})
        sp = engine.stats()["speculative"]
    finally:
        shut("b rpc spec", server, engine, store, free0)
    paged = pa.paged_attention.launches
    paged_cuda = pa.paged_attention.cuda_launches
    flash = attn.flash_attention.launches
    oracle = ctx["oracle"]
    runs = [("cold", cold), ("warm", warm), ("client process", child),
            ("spec", spec_out)]
    runs += [(f"pair {kind}", p[0]) for kind in paired for p in paired[kind]]
    for name, streams in runs:
        for i, (c, o) in enumerate(zip(streams, oracle)):
            check(c == o, f"b rpc {name}: stream {i} streamed {c}, dense "
                          f"oracle {o}")
    check(hit_cold == [0] * N_REQUESTS, f"b rpc: cold prefix_hit {hit_cold}")
    check(all(h > 0 for h in hit_warm + hit_child),
          f"b rpc: warm prefix_hit {hit_warm}, {hit_child}")
    check(rec.kws.count({"speculative": False}) == 1 and
          rec.kws.count({}) == N_REQUESTS - 1,
          f"b rpc spec: submits saw {rec.kws}")
    check(sp["spec_accepted"] > 0, "b rpc spec: no draft was accepted")
    check(paged > 0 and paged_cuda == 2 * paged,
          f"b rpc: launches paged {paged} ({paged_cuda} CUDA)")
    ms = 1e3
    ratios = [r[1] / d[1] for r, d in zip(paired["rpc"], paired["direct"])]
    pairs = {kind: {"tokens_per_s": [p[1] for p in paired[kind]],
                    "step_ms": [p[2] for p in paired[kind]]}
             for kind in paired}
    return {
        "config": "b rpc", "card": card, "requests": N_REQUESTS,
        "new_tokens": NEW_TOKENS, "prompt_len": len(prompts[0]),
        "native_build_s": cbuild.build_seconds,
        "cold_s": t_cold, "warm_s": t_warm,
        "client_process_warm_s": t_child, "spec_s": t_spec,
        "cold_tokens_per_s": toks / t_cold, "warm_tokens_per_s": toks / t_warm,
        "client_process_warm_tokens_per_s": toks / t_child,
        "spec_tokens_per_s": toks / t_spec,
        "pairs": pairs,
        "pair_rpc_over_direct": ratios,
        "pair_rpc_over_direct_quartiles": [pct(ratios, q)
                                           for q in (25, 50, 75)],
        "pair_rpc_wins": sum(r > 1 for r in ratios),
        "pair_tokens_per_s_median": {
            k: pct(v["tokens_per_s"], 50) for k, v in pairs.items()},
        "pair_step_ms_median": {
            k: pct(v["step_ms"], 50) for k, v in pairs.items()},
        "ttft_ms": {k: {"p50": ms * pct(v, 50), "max": ms * max(v)}
                    for k, v in (("cold", ttft_c), ("warm", ttft_w),
                                 ("warm_client_process", ttft_p),
                                 ("spec", ttft_s))},
        "gap_ms": {k: {"p50": ms * pct(v, 50), "p99": ms * pct(v, 99)}
                   for k, v in (("cold", gaps_c), ("warm", gaps_w),
                                ("warm_client_process", gaps_p),
                                ("spec", gaps_s))},
        "warm_prefix_hit_tokens": hit_warm,
        "spec": {"accept_rate": sp["accept_rate"],
                 "tokens_per_verify": sp["tokens_per_verify"],
                 "verify_calls": sp["verify_calls"]},
        "launches": {"paged_attention": paged,
                     "flash_attention": flash},
        "paged_cuda_launches": paged_cuda,
    }


# ---- control-plane phase: Score through the batcher, the supervisor -------

class Counts:
    """Kernel calls summed over the phase's windows: every count is set
    to 0 when a window opens and read when it closes, so the checks'
    own reference computations between windows are not counted."""

    def __init__(self):
        self.paged = self.paged_cuda = self.flash = 0

    def window(self, body):
        import torch
        import brpc_tpu_torch.ops.attention as attn
        import brpc_tpu_torch.ops.paged_attention as pa
        torch.cuda.synchronize()
        pa.paged_attention.launches = 0
        pa.paged_attention.cuda_launches = 0
        attn.flash_attention.launches = 0
        try:
            return body()
        finally:
            self.paged += pa.paged_attention.launches
            self.paged_cuda += pa.paged_attention.cuda_launches
            self.flash += attn.flash_attention.launches

    def as_dict(self):
        return {"paged_attention": self.paged,
                "flash_attention": self.flash}


def unbatched_ids(params, cfg, dev, toks, offset=0):
    """Greedy next-token ids at every position of ONE row through the
    dense forward on the card, and the row's top-2 logit gaps."""
    import torch
    import brpc_tpu_torch.models as models
    t = torch.tensor([list(toks)], dtype=torch.int64, device=dev)
    pos = torch.arange(offset, offset + len(toks), dtype=torch.int32,
                       device=dev)[None]
    logits = models.dense_forward(params, cfg, t, pos)[0]
    top2 = torch.topk(logits, 2, dim=-1).values
    return (torch.argmax(logits, dim=-1).cpu().numpy(),
            (top2[:, 0] - top2[:, 1]).cpu().numpy())


def hold_rows(label, got, want):
    """Every scored row's ids equal to its unbatched forward's, exactly;
    a mismatch names the row, the position and the unbatched logit
    gap there."""
    bad = []
    for k, (i, y) in enumerate(got):
        ids, gaps = want[i]
        y = np.asarray(y).astype(np.int64)
        if y.shape != ids.shape or not np.array_equal(y, ids):
            pos = int(np.argmax(y != ids)) if y.shape == ids.shape else -1
            bad.append({"call": k, "row": i, "position": pos,
                        "batched": int(y[pos]) if pos >= 0 else None,
                        "unbatched": int(ids[pos]) if pos >= 0 else None,
                        "unbatched_top2_gap": float(gaps[pos])
                        if pos >= 0 else None})
    check(not bad, f"{label}: scored ids differ from the unbatched "
                   f"forward: {bad[:4]}")


def score_calls(port, rows, n_frame, n_json, label):
    """``n_frame`` ScoreT calls through ScoreClient (tensorframe) and
    ``n_json`` json Score calls, all issued at once, rows cycling over
    ``rows``.  Returns ``[(row index, y)]``, client-timed latencies per
    wire, and the wall time."""
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    ch = rpc.Channel(f"127.0.0.1:{port}", timeout_ms=120_000)
    out = [None] * (n_frame + n_json)
    lat = {"tensorframe": [], "json": []}
    errs = []

    def one(k):
        i = k % len(rows)
        x = np.asarray(rows[i], np.float32)
        try:
            t0 = time.perf_counter()
            if k < n_frame:
                cli = serving.ScoreClient(ch)
                y = cli.score(x)
                check(cli.wire_mode == "frame",
                      f"{label}: ScoreT negotiated {cli.wire_mode}")
                wire = "tensorframe"
            else:
                y = np.asarray(ch.call_sync(
                    "Serving", "Score", {"x": x.tolist()},
                    serializer="json")["y"], np.float32)
                wire = "json"
            lat[wire].append(time.perf_counter() - t0)
            out[k] = (i, y)
        except Exception as e:
            errs.append(f"call {k}: {type(e).__name__}: {e}")

    ts = [threading.Thread(target=one, args=(k,))
          for k in range(n_frame + n_json)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    check(not errs and all(o is not None for o in out),
          f"{label}: {errs[:4] or 'a call hung'}")
    return out, lat, wall


def serve_control(dev, cfg, ctx, card):
    """Step 7 (see the module docstring): (b)'s weights, prompts and dense
    oracle behind one Server with a DynamicBatcher (Score/ScoreT) and an
    EngineSupervisor (Generate)."""
    import torch
    import brpc_tpu_torch.fault as fault
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    import brpc_tpu_torch.serving.speculative as spec
    from brpc_tpu_torch import errors
    geo, prompts, oracle = ctx["geometry"], ctx["prompts"], ctx["oracle"]
    params = ctx["params"]
    toks = N_REQUESTS * NEW_TOKENS
    counts = Counts()
    # the checks' references, computed outside every counting window
    want = [unbatched_ids(params, cfg, dev, p) for p in prompts]
    for i, (ids, _) in enumerate(want):
        check(int(ids[-1]) == oracle[i][0],
              f"b control: row {i}'s last unbatched id {int(ids[-1])} is "
              f"not the oracle's first token {oracle[i][0]}")

    def supervised(label, store, **engine_kw):
        def factory():
            runner = models.TransformerRunner(params, cfg, store=store,
                                              device=dev, name=label)
            return serving.DecodeEngine(
                runner=runner, store=store, num_slots=geo["num_slots"],
                max_pages_per_slot=geo["max_pages"],
                prefill_buckets=geo["buckets"], device=dev, name=label,
                **engine_kw)
        return factory

    def crashed_pass(label, port, sup, store, site, after):
        """One pass of 8 streams over RPC with one crash at ``site``:
        every stream the oracle's, exactly once, one restart, and the
        re-admissions hitting the detached pages."""
        plan = fault.FaultPlan(7).on(site, fault.ERROR, times=1,
                                     after=after)
        hit0 = store.hit_tokens
        with fault.injected(plan):
            streams, _, ttft, gaps, wall = counts.window(
                lambda: rpc_generate_all(port, prompts, label))
        check(sup.join_idle(60), f"{label}: the supervisor did not go idle")
        st = sup.stats()
        rec = st["last_recovery"] or {}
        check(plan.injected.get(site) == 1,
              f"{label}: the fault fired {plan.injected}")
        check(st["restarts"] == 1 and st["readmitted"] >= 1,
              f"{label}: restarts {st['restarts']}, readmitted "
              f"{st['readmitted']}")
        check(rec.get("pinned_seqs", 0) > 0
              and store.hit_tokens - hit0 > 0,
              f"{label}: the re-admissions hit no pinned prefix "
              f"({rec}, {store.hit_tokens - hit0} hit tokens)")
        check("detect_to_first_token_ms" in rec,
              f"{label}: no resumed token after the rebuild ({rec})")
        for i, (c, o) in enumerate(zip(streams, oracle)):
            check(c == o, f"{label}: stream {i} streamed {c}, dense oracle "
                          f"{o}")
        return {"tokens_per_s": toks / wall, "wall_s": wall,
                "restarts": st["restarts"], "readmitted": st["readmitted"],
                "resumed_tokens": st["resumed_tokens"],
                "readmit_hit_tokens": store.hit_tokens - hit0,
                "recovery": rec, "ttft_ms_p50": 1e3 * pct(ttft, 50),
                "gap_ms_p99": 1e3 * pct(gaps, 99)}

    def shut(label, server, sup, store, free0, batchers=()):
        check(sup.join_idle(30), f"{label}: the supervisor did not go idle")
        live = store.stats()["live_seqs"]
        check(live == 0, f"{label}: {live} sequences still live")
        server.stop()
        server.join()
        sup.close()
        for b in batchers:
            b.close()
        store.clear()
        check(store.pagepool.blocks_leased() == 0 and
              store.pagepool.pool.stats()["classes"] == free0,
              f"{label}: the page pool did not return to its baseline")

    label = "b control"
    store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                  max_blocks=geo["max_blocks"], device=dev,
                                  name=label)
    free0 = store.pagepool.pool.stats()["classes"]
    score_runner = models.TransformerRunner(params, cfg, device=dev,
                                            name="b score")
    batcher = serving.DynamicBatcher(
        score_runner, max_batch_size=8, max_delay_us=5000,
        length_buckets=(64, 256), dtype=np.int32, name="b_score")
    pbatcher = serving.DynamicBatcher(
        score_runner, max_batch_size=8, max_delay_us=5000,
        length_buckets=(64, 256), prefix_cache=store, dtype=np.int32,
        name="b_score_prefix")
    sup = serving.EngineSupervisor(
        supervised(label, store), store=store, batcher=batcher,
        heartbeat_deadline_s=30.0, check_interval_s=0.02,
        ladder=CALM_LADDER, name="b_control")
    server = rpc.Server()
    serving.register_serving(server, batcher=batcher, engine=sup)
    server.start("127.0.0.1", 0)
    try:
        # -- Score: 32 ScoreT + 8 json, through the batcher into K2
        b0 = batcher.stats()["batches"]
        flash0 = counts.flash
        scored, lat, t_score = counts.window(lambda: score_calls(
            server.port, prompts, SCORE_T_CALLS, SCORE_JSON_CALLS,
            "b control score"))
        bst = batcher.stats()
        qd50 = batcher.queue_delay_rec.latency_percentile(0.5)
        batches = bst["batches"] - b0
        check(counts.flash - flash0 == cfg.n_layers * batches,
              f"b control score: {counts.flash - flash0} flash calls for "
              f"{batches} batches of {cfg.n_layers} layers")
        hold_rows("b control score", scored, want)
        # one more batch of 8 ScoreT rows under the profiler: where a
        # Score batch's device time goes, and the device's busy share
        (prof_rows, _, _), prof = counts.window(lambda: profile_window(
            lambda: score_calls(server.port, prompts, N_REQUESTS, 0,
                                "b control score profiled")))
        hold_rows("b control score profiled", prof_rows, want)
        score = {
            "rows": len(scored), "rows_per_s": len(scored) / t_score,
            "wall_s": t_score, "batches": batches,
            "avg_batch_size": bst["avg_batch_size"],
            "pad_waste_ratio": bst["pad_waste_ratio"],
            "queue_delay_p50_us": qd50,
            "queue_delay_p99_us": bst["queue_delay_p99_us"],
            "exec_ema_ms": bst["exec_ema_ms"],
            "flash_calls": counts.flash - flash0,
            "profile": prof,
            "latency_ms": {w: {"p50": 1e3 * pct(v, 50),
                               "p99": 1e3 * pct(v, 99)}
                           for w, v in lat.items()}}
        # -- supervised Generate: one step crash, then an uncrashed pass
        crashed = crashed_pass("b control crash", server.port, sup, store,
                               fault.STEP, after=8)
        store.clear()                 # the uncrashed pass runs cold too
        uncrashed, _, _, _, t_plain = counts.window(
            lambda: rpc_generate_all(server.port, prompts,
                                     "b control uncrashed"))
        for i, (c, o) in enumerate(zip(uncrashed, oracle)):
            check(c == o, f"b control uncrashed: stream {i} streamed {c}, "
                          f"dense oracle {o}")
        # -- Score again, prefix-cached: each row its uncached suffix
        hits = [store.probe(p) for p in prompts]
        suffix_want = [unbatched_ids(params, cfg, dev, p[h:], offset=h)
                       for p, h in zip(prompts, hits)]
        outs = [None] * N_REQUESTS

        def prefixed(i):
            outs[i] = (i, pbatcher.submit_wait(
                np.asarray(prompts[i], np.int32), timeout_s=120))

        def prefixed_all():
            ts = [threading.Thread(target=prefixed, args=(i,))
                  for i in range(N_REQUESTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)

        counts.window(prefixed_all)
        check(all(o is not None for o in outs),
              "b control prefix score: a call hung")
        hold_rows("b control prefix score", outs, suffix_want)
        pst = pbatcher.stats()
        check(pst["prefix_skip_ratio"] > 0,
              f"b control prefix score: skip ratio "
              f"{pst['prefix_skip_ratio']}")
        # -- brownout: level floor 1 sheds the deadline-less lane
        shed0 = batcher.brownout_shed.get_value()
        sup.set_level_floor(1)
        t_end = time.monotonic() + 10
        while batcher.brownout < 1 and time.monotonic() < t_end:
            time.sleep(0.01)
        check(batcher.brownout == 1, "b control: the brownout never applied")
        x0 = {"x": [float(t) for t in prompts[0]]}
        try:
            rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=0
                        ).call_sync("Serving", "Score", x0,
                                    serializer="json")
            shed_code = 0
        except errors.RpcError as e:
            shed_code = e.code
        check(shed_code == errors.ELIMIT,
              f"b control brownout: a deadline-less Score got {shed_code}")
        served = counts.window(lambda: rpc.Channel(
            f"127.0.0.1:{server.port}", timeout_ms=120_000).call_sync(
                "Serving", "Score", x0, serializer="json"))
        hold_rows("b control brownout", [(0, served["y"])], want)
        brown_shed = batcher.brownout_shed.get_value() - shed0
        check(brown_shed == 1, f"b control: brownout_shed rose by "
                               f"{brown_shed}")
        sup.set_level_floor(0)
        pool_pages = store.stats()["pages"]["pages_in_use"]
    finally:
        shut(label, server, sup, store, free0, (batcher, pbatcher))
    # -- the speculative engine under its own supervisor, one verify crash
    label = "b control spec"
    store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                  max_blocks=geo["max_blocks"], device=dev,
                                  name=label)
    free0 = store.pagepool.pool.stats()["classes"]
    sup = serving.EngineSupervisor(
        supervised(label, store, draft_runner=spec.NGramProposer(),
                   draft_len=4),
        store=store, heartbeat_deadline_s=30.0, check_interval_s=0.02,
        ladder=CALM_LADDER, name="b_control_spec")
    server = rpc.Server()
    serving.register_serving(server, engine=sup)
    server.start("127.0.0.1", 0)
    try:
        crashed_spec = crashed_pass("b control spec crash", server.port,
                                    sup, store, fault.SPEC_VERIFY,
                                    after=2)
    finally:
        shut(label, server, sup, store, free0)
    check(counts.paged > 0 and counts.paged_cuda == 2 * counts.paged,
          f"b control: {counts.paged} paged calls, {counts.paged_cuda} "
          f"CUDA launches")
    return {
        "config": "b control", "card": card, "score": score,
        "prefix_score": {"rows": len(outs),
                         "prefix_skip_ratio": pst["prefix_skip_ratio"],
                         "hit_tokens": hits,
                         "pad_waste_ratio": pst["pad_waste_ratio"]},
        "crashed": crashed, "uncrashed_tokens_per_s": toks / t_plain,
        "crashed_spec": crashed_spec,
        "brownout": {"deadline_less_code": shed_code,
                     "brownout_shed": brown_shed},
        "pages_in_use_before_close": pool_pages,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- host-path phase: the native hot path, rpcz, locks, host CPU ---------

def check_rings(label, base):
    """No native emit ring outlives its request: the port core's live
    count back at ``base`` (emitter threads may still be unwinding)."""
    import gc
    import brpc_tpu_torch.native_path as native_path
    deadline = time.monotonic() + 10
    while True:
        gc.collect()
        live = native_path.tokring_live()
        if live == base or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check(live == base, f"{label}: {live - base} native emit rings leaked")


class SwapBatcher:
    """The batcher the Serving service sees: each Score pass installs a
    fresh DynamicBatcher, so a pass's batch-time EMA is its own."""

    def __init__(self):
        self.current = None

    def submit(self, cntl, item, transform=None):
        return self.current.submit(cntl, item, transform)


def trace_shape(spans, root):
    """Check one traced Generate: client root -> server -> generation ->
    decode (KV annotations) -> prefill, all in the root's trace.
    Returns the span count per kind."""
    by_kind = {}
    for s in spans:
        check(s.trace_id == root.trace_id, "a span left the trace")
        by_kind.setdefault(s.kind, []).append(s)
    server = by_kind.get("server", [None])[0]
    gen = by_kind.get("generation", [None])[0]
    decode = by_kind.get("decode", [None])[0]
    prefill = by_kind.get("prefill", [None])[0]
    check(None not in (server, gen, decode, prefill),
          f"b host traced generate: kinds {sorted(by_kind)}")
    check(server.parent_span_id == root.span_id
          and gen.parent_span_id == server.span_id
          and decode.parent_span_id == gen.span_id
          and prefill.parent_span_id == decode.span_id,
          "b host traced generate: the span tree is not client -> server "
          "-> generation -> decode -> prefill")
    notes = " | ".join(m for _, m in decode.annotations)
    for want in ("kv admit:", "first token:", "retired:"):
        check(want in notes, f"b host traced generate: decode span lacks "
                             f"{want!r}: {notes}")
    return {k: len(v) for k, v in sorted(by_kind.items())}


def serve_host_path(dev, cfg, ctx, card):
    """Step 8 (see the module docstring): the host path of (b) under the
    reference's default native hot path and with it off, rpcz, the lock
    ledger and host-CPU accounting."""
    import brpc_tpu_torch.flags as flags
    import brpc_tpu_torch.fault as fault
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.native_path as native_path
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.rpcz as rpcz
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch import errors
    from brpc_tpu_torch.butil import hostcpu, lockprof
    geo, prompts, oracle = ctx["geometry"], ctx["prompts"], ctx["oracle"]
    params = ctx["params"]
    toks = N_REQUESTS * NEW_TOKENS
    counts = Counts()
    want = [unbatched_ids(params, cfg, dev, p) for p in prompts]
    rings0 = native_path.tokring_live()
    waits0 = {n: r["wait_total_us"]
              for n, r in lockprof.locks_snapshot().items()}
    label = "b host"

    def held(label, streams):
        for i, (c, o) in enumerate(zip(streams, oracle)):
            check(c == o, f"{label}: stream {i} streamed {c}, dense oracle "
                          f"{o}")

    def factory():
        runner = models.TransformerRunner(params, cfg, store=store,
                                          device=dev, name=label)
        return serving.DecodeEngine(
            runner=runner, store=store, num_slots=geo["num_slots"],
            max_pages_per_slot=geo["max_pages"],
            prefill_buckets=geo["buckets"], device=dev, name="b_host")

    def set_native(on):
        check(flags.set_flag("native_hot_path_enabled", on),
              "the native hot path flag is not reloadable")

    store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                  max_blocks=geo["max_blocks"], device=dev,
                                  name=label)
    free0 = store.pagepool.pool.stats()["classes"]
    score_runner = models.TransformerRunner(params, cfg, device=dev,
                                            name="b host score")
    swap = SwapBatcher()
    sup = serving.EngineSupervisor(
        factory, store=store, heartbeat_deadline_s=30.0,
        check_interval_s=0.02, ladder=CALM_LADDER, name="b_host")
    server = rpc.Server()
    serving.register_serving(server, batcher=swap, engine=sup)
    server.start("127.0.0.1", 0)
    port = server.port
    try:
        held("b host cold", counts.window(
            lambda: generate_all(sup, prompts, "b host cold")))
        # -- native hot path on and off, in alternating pairs, direct
        # (in-process submits) and over RPC, on one supervised engine
        pairs = {via: {"on": [], "off": []} for via in ("direct", "rpc")}
        cpu = {via: {"on": {}, "off": {}} for via in ("direct", "rpc")}
        for via in ("direct", "rpc"):
            for i in range(HOST_PAIRS):
                for on in (True, False) if i % 2 == 0 else (False, True):
                    set_native(on)
                    eng = sup.engine
                    steps0, sec0 = eng.steps.get_value(), eng.step_seconds
                    h0 = hostcpu.snapshot()
                    t0 = time.perf_counter()
                    if via == "direct":
                        streams = counts.window(lambda: generate_all(
                            sup, prompts, "b host direct"))
                    else:
                        streams = counts.window(lambda: rpc_generate_all(
                            port, prompts, "b host rpc")[0])
                    t = time.perf_counter() - t0
                    h1 = hostcpu.snapshot()
                    held(f"b host {via} flag {on}", streams)
                    key = "on" if on else "off"
                    pairs[via][key].append(
                        (toks / t, 1e3 * (eng.step_seconds - sec0)
                         / max(1, eng.steps.get_value() - steps0)))
                    acc = cpu[via][key]
                    for stage, us in h1["per_stage_us"].items():
                        acc[stage] = acc.get(stage, 0) + us \
                            - h0["per_stage_us"][stage]
                    acc["tokens"] = acc.get("tokens", 0) + h1["tokens"] \
                        - h0["tokens"]
        set_native(True)
        # the crash below replaces this engine; a reference held here
        # would keep its crash's traceback, and the requests in it, alive
        del eng
        hostcpu_us_per_token = {
            via: {key: {stage: us / max(1, acc["tokens"])
                        for stage, us in acc.items() if stage != "tokens"}
                  for key, acc in per.items()}
            for via, per in cpu.items()}

        def pair_stats(rows):
            out = {"on_ahead": 0}
            for k, metric in enumerate(("tokens_per_s", "step_ms")):
                vals = {key: [r[k] for r in rows[key]] for key in rows}
                out[metric] = vals
                out[metric + "_median"] = {key: pct(v, 50)
                                           for key, v in vals.items()}
                out[metric + "_quartiles"] = {
                    key: [pct(v, 25), pct(v, 75)]
                    for key, v in vals.items()}
            ratios = [a / b for a, b in zip(out["tokens_per_s"]["on"],
                                            out["tokens_per_s"]["off"])]
            out["on_over_off_quartiles"] = [pct(ratios, q)
                                            for q in (25, 50, 75)]
            out["on_ahead"] = sum(r > 1 for r in ratios)
            return out

        flag_pairs = {via: pair_stats(rows) for via, rows in pairs.items()}
        # -- Score with the flag on and off: 16 ScoreT rows a pass, a
        # fresh batcher per pass (its batch-time EMA is the pass's own)
        score = {"on": [], "off": []}
        for i in range(SCORE_PAIRS):
            for on in (True, False) if i % 2 == 0 else (False, True):
                set_native(on)
                swap.current = serving.DynamicBatcher(
                    score_runner, max_batch_size=8, max_delay_us=5000,
                    length_buckets=(64, 256), dtype=np.int32,
                    name="b_host_score")
                try:
                    rows, _, wall = counts.window(lambda: score_calls(
                        port, prompts, 2 * N_REQUESTS, 0, "b host score"))
                    bst = swap.current.stats()
                finally:
                    swap.current.close()
                hold_rows(f"b host score flag {on}", rows, want)
                score["on" if on else "off"].append(
                    {"rows_per_s": len(rows) / wall,
                     "exec_ema_ms": bst["exec_ema_ms"],
                     "batches": bst["batches"]})
        set_native(True)
        score_medians = {
            k: {"rows_per_s": pct([r["rows_per_s"] for r in v], 50),
                "exec_ema_ms": pct([r["exec_ema_ms"] for r in v], 50)}
            for k, v in score.items()}
        # -- rpcz on: one traced Generate, one traced Score
        rpcz.set_enabled(True)
        roots = []
        held("b host traced", counts.window(lambda: rpc_generate_all(
            port, prompts[:1], "b host traced", roots=roots)[0]))
        check(sup.join_idle(30), "b host: the supervisor did not go idle")
        gen_spans = rpcz.recent_spans(limit=2048,
                                      trace_id=roots[0].trace_id)
        span_kinds = trace_shape(gen_spans, roots[0])
        gen_tree = [f"{'  ' * depth}{sp.kind} {sp.service}.{sp.method}"
                    for depth, _, sp in rpcz.trace_tree(gen_spans)]
        swap.current = serving.DynamicBatcher(
            score_runner, max_batch_size=8, max_delay_us=5000,
            length_buckets=(64, 256), dtype=np.int32, name="b_host_score")
        try:
            sroot = rpcz.new_span("client", "Serving", "ScoreT")
            rpcz.set_current_span(sroot)
            try:
                y = counts.window(lambda: serving.ScoreClient(rpc.Channel(
                    f"127.0.0.1:{port}", timeout_ms=120_000)).score(
                        np.asarray(prompts[0], np.float32)))
            finally:
                rpcz.set_current_span(None)
            rpcz.submit(sroot)
        finally:
            swap.current.close()
        hold_rows("b host traced score", [(0, y)], want)
        score_spans = rpcz.recent_spans(limit=2048, trace_id=sroot.trace_id)
        sserver = [s for s in score_spans if s.kind == "server"]
        batch = [s for s in score_spans if s.kind == "batch"]
        check(len(sserver) == 1 and len(batch) == 1
              and sserver[0].parent_span_id == sroot.span_id
              and batch[0].parent_span_id == sserver[0].span_id
              and any("queue_delay_us=" in m
                      for _, m in batch[0].annotations),
              f"b host traced score: {[(s.kind, s.annotations) for s in score_spans]}")
        for s in score_spans:
            span_kinds["score " + s.kind] = \
                span_kinds.get("score " + s.kind, 0) + 1
        # what tracing costs: RPC passes with rpcz on and off, in turns
        traced = {"on": [], "off": []}
        for i in range(TRACE_PAIRS):
            for on in (True, False) if i % 2 == 0 else (False, True):
                rpcz.set_enabled(on)
                streams, _, _, _, wall = counts.window(
                    lambda: rpc_generate_all(port, prompts, "b host trace"))
                held(f"b host rpcz {on}", streams)
                traced["on" if on else "off"].append(toks / wall)
        # one supervised pass with a step crash, every stream traced: the
        # two attempts of each generation share its trace
        rpcz.set_enabled(True)
        roots = []
        plan = fault.FaultPlan(9).on(fault.STEP, fault.ERROR, times=1,
                                     after=8)
        with fault.injected(plan):
            streams, _, _, _, t_crash = counts.window(
                lambda: rpc_generate_all(port, prompts, "b host crash",
                                         roots=roots))
        held("b host crash", streams)
        check(sup.join_idle(60), "b host crash: the supervisor did not go "
                                 "idle")
        check(plan.injected.get(fault.STEP) == 1 and
              sup.stats()["restarts"] == 1,
              f"b host crash: fault {plan.injected}, restarts "
              f"{sup.stats()['restarts']}")
        # every re-admitted generation: both attempts (and both decode
        # spans) in its trace, the second linked to the first
        readmitted = sup.stats()["readmitted"]
        linked = 0
        for root in roots:
            spans = rpcz.recent_spans(limit=2048, trace_id=root.trace_id)
            gens = sorted((s for s in spans if s.kind == "generation"),
                          key=lambda s: s.span_id)
            decodes = [s for s in spans if s.kind == "decode"]
            if len(gens) >= 2:
                check(gens[1].recovered_from == gens[0].span_id
                      and len(decodes) >= 2
                      and any(d.error_code == errors.ELOGOFF
                              for d in decodes),
                      f"b host crash: trace {root.trace_id}'s attempts "
                      f"are not linked")
                linked += 1
        check(readmitted > 0 and linked == readmitted,
              f"b host crash: {linked} linked traces, {readmitted} "
              f"re-admitted generations")
        rpcz.set_enabled(False)
        check(sup.join_idle(30), "b host: the supervisor did not go idle")
        live = store.stats()["live_seqs"]
        check(live == 0, f"b host: {live} sequences still live")
    finally:
        rpcz.set_enabled(False)
        set_native(True)
        server.stop()
        server.join()
        sup.close()
        store.clear()
    check(store.pagepool.blocks_leased() == 0 and
          store.pagepool.pool.stats()["classes"] == free0,
          "b host: the page pool did not return to its baseline")
    check_rings("b host", rings0)
    violations = lockprof.order_violations()
    check(not violations, "lock-order violations:\n"
                          + lockprof.witness_report())
    waits = []
    for name, row in lockprof.locks_snapshot().items():
        waits.append({"lock": name,
                      "wait_us": row["wait_total_us"] - waits0.get(name, 0),
                      "contentions": row["contentions"],
                      "acquisitions": row["acquisitions"],
                      "wait_p99_us": row["wait_p99_us"],
                      "hold_p99_us": row["hold_p99_us"]})
    waits.sort(key=lambda r: r["wait_us"], reverse=True)
    check(counts.paged > 0 and counts.paged_cuda == 2 * counts.paged
          and counts.flash > 0,
          f"b host: {counts.paged} paged calls ({counts.paged_cuda} CUDA), "
          f"{counts.flash} flash calls")
    return {
        "config": "b host", "card": card, "requests": N_REQUESTS,
        "new_tokens": NEW_TOKENS, "flag_pairs": flag_pairs,
        "hostcpu_us_per_token": hostcpu_us_per_token,
        "score": score, "score_medians": score_medians,
        "span_kinds": span_kinds, "generate_tree": gen_tree,
        "traced_tokens_per_s": traced,
        "traced_tokens_per_s_median": {k: pct(v, 50)
                                       for k, v in traced.items()},
        "crash_tokens_per_s": toks / t_crash,
        "crash_traces_linked": linked,
        "top_lock_waits": waits[:5], "lock_order_violations": 0,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- replicas phase: two replicas behind the port's cluster channel -----

def free_port():
    """A loopback port nothing listens on now (each replica's supervisor
    names its endpoint before the replica's server starts)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def family_prompts(cfg, eps, seed):
    """REPLICA_FAMILIES prefix families of FAMILY_SIZE prompts: a family
    shares a FAMILY_HEAD-token head, each prompt its own FAMILY_TAIL-token
    tail.  Heads are drawn from ``seed`` and taken in draw order, half of
    the families owned by each replica on the prefix_affinity ring over
    ``eps``, so both replicas serve (the ring's owner of a head depends
    on the servers' ports)."""
    import brpc_tpu_torch.policy.load_balancer as lbm
    lb = lbm.create_load_balancer("prefix_affinity")
    lb.reset_servers([lbm.ServerNode(ep) for ep in eps])
    rng = np.random.default_rng(seed)
    want = REPLICA_FAMILIES // len(eps)
    owned = {str(ep): [] for ep in eps}
    for _ in range(1000):
        head = rng.integers(0, cfg.vocab, FAMILY_HEAD).tolist()
        owner = str(lb.select_server(
            request_code=lbm.prefix_fingerprint(head)))
        if len(owned[owner]) < want:
            owned[owner].append(head)
        if all(len(v) == want for v in owned.values()):
            break
    check(all(len(v) == want for v in owned.values()),
          f"b replicas: the ring gave no {want} heads to each replica")
    families = []
    for ep in eps:
        for head in owned[str(ep)]:
            families.append({
                "owner": str(ep),
                "prompts": [head + rng.integers(0, cfg.vocab,
                                                FAMILY_TAIL).tolist()
                            for _ in range(FAMILY_SIZE)]})
    return families


def serve_replicas(dev, cfg, ctx, card):
    """Step 9 (see the module docstring): (b)'s weights on two replicas
    behind the port's cluster channel."""
    import brpc_tpu_torch.fault as fault
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.native_path as native_path
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch.butil import lockprof
    from brpc_tpu_torch.butil.endpoint import EndPoint
    from brpc_tpu_torch.ici.block_pool import BlockPool
    from brpc_tpu_torch.policy import health_check
    from brpc_tpu_torch.policy.circuit_breaker import (CircuitBreaker,
                                                       global_breaker)
    from brpc_tpu_torch.policy.load_balancer import prefix_fingerprint
    t_phase = time.perf_counter()
    geo, params = ctx["geometry"], ctx["params"]
    counts = Counts()
    rings0 = native_path.tokring_live()
    # retire the probes of the earlier phases' stopped servers, then
    # probe every 50 ms: the revival below waits on it
    health_check.reset_all()
    interval0 = health_check.health_check_interval_s
    health_check.health_check_interval_s = 0.05
    breaker = global_breaker()
    label = "b replicas"

    replicas = []

    def replica(i):
        name = f"b_rep{i}"
        ep = EndPoint("127.0.0.1", free_port())
        # a block pool of its own: the replica's device memory, as if
        # it ran on a card of its own
        store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                      max_blocks=geo["max_blocks"],
                                      pool=BlockPool(dev), name=name)

        def factory():
            runner = models.TransformerRunner(params, cfg, store=store,
                                              device=dev, name=name)
            return serving.DecodeEngine(
                runner=runner, store=store, num_slots=geo["num_slots"],
                max_pages_per_slot=geo["max_pages"],
                prefill_buckets=geo["buckets"], device=dev, name=name)

        batcher = serving.DynamicBatcher(
            models.TransformerRunner(params, cfg, device=dev,
                                     name=f"{name} score"),
            max_batch_size=8, max_delay_us=5000, length_buckets=(64, 256),
            dtype=np.int32, name=f"{name}_score")
        sup = serving.EngineSupervisor(
            factory, store=store, heartbeat_deadline_s=30.0,
            check_interval_s=0.02, ladder=CALM_LADDER, endpoint=ep,
            quarantine_after=3, name=name)
        server = rpc.Server()
        serving.register_serving(server, batcher=batcher, engine=sup)
        server.start(ep.host, ep.port)
        return {"name": name, "ep": ep, "addr": str(ep), "store": store,
                "free0": store.pagepool.pool.stats()["classes"],
                "batcher": batcher, "sup": sup, "server": server}

    try:
        for i in range(2):
            replicas.append(replica(i))
        r0, r1 = replicas
        eps = [r["ep"] for r in replicas]
        side_of = {r["addr"]: r for r in replicas}
        cluster = rpc.Channel(f"list://{r0['addr']},{r1['addr']}",
                              timeout_ms=120_000,
                              load_balancer="prefix_affinity")
        families = family_prompts(cfg, eps, seed=21)
        prompts = [p for f in families for p in f["prompts"]]
        fam_of = [k for k, f in enumerate(families) for _ in f["prompts"]]
        codes = [prefix_fingerprint(p) for p in prompts]
        # two waves of 8 a pass: each wave holds every family
        waves = [[i for i in range(len(prompts))
                  if i % FAMILY_SIZE in (w, w + 2)] for w in range(2)]
        # the checks' references, outside every counting window
        t0 = time.perf_counter()
        oracle = [models.dense_generate(params, cfg, p, NEW_TOKENS,
                                        device=dev) for p in prompts]
        want = [unbatched_ids(params, cfg, dev, p) for p in prompts]
        t_refs = time.perf_counter() - t0
        rows = [np.asarray(p, np.float32) for p in prompts]
        toks = len(prompts) * NEW_TOKENS

        def held(what, idx, streams):
            for i, got in zip(idx, streams):
                check(got == oracle[i], f"{label} {what}: request {i} "
                                        f"streamed {got}, dense oracle "
                                        f"{oracle[i]}")

        def gen_pass(ch, what, idx_waves=waves, routed=True):
            """The prompts of ``idx_waves``, a wave (8 streams) at a
            time; every stream the oracle's.  Returns the wall time, the
            prefix hits and the server of each request, by index."""
            hits, sides = {}, {}
            t0 = time.perf_counter()
            for idx in idx_waves:
                recs = issue_generates(
                    ch, [prompts[i] for i in idx],
                    codes=[codes[i] for i in idx] if routed else None)
                streams, h, _, _, sd = wait_generates(recs,
                                                      f"{label} {what}")
                held(what, idx, streams)
                hits.update(zip(idx, h))
                sides.update(zip(idx, sd))
            return time.perf_counter() - t0, hits, sides

        def owners_hold(what, sides, moved=()):
            """Each family on one replica: its ring owner, or the
            survivor for a family in ``moved``."""
            for i, side in sides.items():
                f = families[fam_of[i]]
                expect = r1["addr"] if fam_of[i] in moved else f["owner"]
                check(side == expect, f"{label} {what}: request {i} of "
                                      f"family {fam_of[i]} went to {side}, "
                                      f"not {expect}")

        # -- Score fan-out first: the breaker's latency windows start on
        # Score calls (see PERF.md on latency isolation across methods)
        chans = [rpc.Channel(r["addr"], timeout_ms=120_000)
                 for r in replicas]

        class Halves(rpc.CallMapper):
            def map(self, i, n, request):
                return rpc.SubCall({"x": request["rows"][i]})

        class InOrder(rpc.ResponseMerger):
            def merge(self, responses):
                return [np.asarray(r["y"]) for r in responses]

        fan = rpc.ParallelChannel(call_mapper=Halves(),
                                  response_merger=InOrder())
        for ch in chans:
            fan.add_channel(ch)
        pairs = [(2 * k, 2 * k + 1) for k in range(len(rows) // 2)]

        def fan_pass():
            cntls = [fan.call("Serving", "ScoreT",
                              {"rows": [rows[a], rows[b]]},
                              cntl=rpc.Controller(timeout_ms=120_000),
                              serializer="tensorframe") for a, b in pairs]
            out = []
            for (a, b), c in zip(pairs, cntls):
                c.join()
                check(not c.failed(), f"{label} fan-out: {c.error_code} "
                                      f"{c.error_text}")
                out += [(a, c.response[0]), (b, c.response[1])]
            return out

        def single_pass():
            cntls = [chans[0].call("Serving", "ScoreT", {"x": row},
                                   cntl=rpc.Controller(timeout_ms=120_000),
                                   serializer="tensorframe")
                     for row in rows]
            for c in cntls:
                c.join()
                check(not c.failed(), f"{label} one-replica score: "
                                      f"{c.error_code} {c.error_text}")
            return [(i, c.response["y"]) for i, c in enumerate(cntls)]

        score_rps = {"fanned": [], "single": []}
        for k in range(SCORE_FAN_PAIRS):
            for mode in (("fanned", "single") if k % 2 == 0
                         else ("single", "fanned")):
                t0 = time.perf_counter()
                got = counts.window(fan_pass if mode == "fanned"
                                    else single_pass)
                score_rps[mode].append(len(rows)
                                       / (time.perf_counter() - t0))
                hold_rows(f"{label} score {mode}", got, want)
        part = rpc.PartitionChannel(2)
        part.add_partition(0, chans[0]).add_partition(1, chans[1])
        part_out = [None] * len(pairs)

        def partitioned(k):
            a, b = pairs[k]
            part_out[k] = part.call_partitioned(
                "Serving", "ScoreT", {0: {"x": rows[a]}, 1: {"x": rows[b]}},
                serializer="tensorframe", timeout_ms=120_000)

        def partition_pass():
            ts = [threading.Thread(target=partitioned, args=(k,))
                  for k in range(len(pairs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)

        counts.window(partition_pass)
        check(all(o is not None for o in part_out),
              f"{label} partition score: a call failed or hung")
        hold_rows(f"{label} partition score",
                  [(i, part_out[k][j]["y"]) for k, ab in enumerate(pairs)
                   for j, i in enumerate(ab)], want)

        # -- a backup request: R0's batch stalls 0.2 s, the backup after
        # 20 ms lands on R1 (rr's first pick is R0)
        backup_ch = rpc.Channel(f"list://{r0['addr']},{r1['addr']}",
                                timeout_ms=120_000, load_balancer="rr",
                                backup_request_ms=20)
        plan = fault.FaultPlan(5).on(
            fault.BATCH, fault.LATENCY, latency_s=0.2, times=1,
            match=lambda c: c.get("name") == r0["batcher"].name)
        b0 = r0["batcher"].stats()["batches"]
        bcntl = rpc.Controller()

        def backup_call():
            t0 = time.perf_counter()
            y = serving.ScoreClient(backup_ch).score(rows[0], cntl=bcntl)
            took = time.perf_counter() - t0
            # the stalled primary still runs its batch: wait it out
            # inside the window, so its kernel launches count here
            end = time.monotonic() + 30
            while (r0["batcher"].stats()["batches"] == b0
                   and time.monotonic() < end):
                time.sleep(0.005)
            return y, took

        with fault.injected(plan):
            y, t_backup = counts.window(backup_call)
        check(plan.injected.get(fault.BATCH) == 1,
              f"{label} backup: the stall fired {plan.injected}")
        check(bcntl.retried_count == 1 and bcntl.remote_side == r1["addr"]
              and t_backup < 0.2,
              f"{label} backup: retried {bcntl.retried_count}, from "
              f"{bcntl.remote_side}, {t_backup:.3f} s")
        hold_rows(f"{label} backup", [(0, y)], want)

        # -- Generate through the cluster channel, cold then warm
        hit_before = [r["store"].hit_tokens for r in replicas]
        t_cold, _, sides = counts.window(lambda: gen_pass(cluster, "cold"))
        owners_hold("cold", sides)
        hit_cold = [r["store"].hit_tokens for r in replicas]
        t_warm, hits, sides = counts.window(lambda: gen_pass(cluster,
                                                             "warm"))
        owners_hold("warm", sides)
        hit_warm = [r["store"].hit_tokens - h
                    for r, h in zip(replicas, hit_cold)]
        for i, h in hits.items():
            f = families[fam_of[i]]
            other = r1 if f["owner"] == r0["addr"] else r0
            check(h >= FAMILY_HEAD - 16,
                  f"{label} warm: request {i} hit {h} tokens on its "
                  f"owner")
            check(other["store"].probe(prompts[i]) == 0,
                  f"{label} warm: family {fam_of[i]} is cached on "
                  f"{other['addr']} too")

        # -- quarantine: R0's engine crash-loops with its families in
        # flight; past 3 crashes R0 is marked broken, a wave issued then
        # moves R0's families to R1, R1's stay
        r0_fams = [k for k, f in enumerate(families)
                   if f["owner"] == r0["addr"]]
        crash_idx = [i for i in range(len(prompts)) if fam_of[i] in r0_fams]
        moved_idx = waves[0]
        plan = fault.FaultPlan(7).on(
            fault.STEP, fault.ERROR, times=3,
            match=lambda c: c.get("name") == r0["name"])

        revived = {}

        def watch_revival():
            end = time.monotonic() + 30
            while (health_check.is_broken(r0["ep"])
                   and time.monotonic() < end):
                time.sleep(0.001)
            revived["t"] = time.monotonic()

        watcher = threading.Thread(target=watch_revival)

        def quarantine():
            with fault.injected(plan):
                crash = issue_generates(cluster,
                                        [prompts[i] for i in crash_idx],
                                        codes=[codes[i] for i in crash_idx])
                end = time.monotonic() + 60
                while (not health_check.is_broken(r0["ep"])
                       and time.monotonic() < end):
                    time.sleep(0.001)
                t_q = time.monotonic()
                tp_q = time.perf_counter()
                watcher.start()         # stamps the revival
                broken = health_check.is_broken(r0["ep"])
                quarantined = r0["sup"].stats()["quarantined"]
                moved = issue_generates(cluster,
                                        [prompts[i] for i in moved_idx],
                                        codes=[codes[i] for i in moved_idx])
                still = health_check.is_broken(r0["ep"])
                crashed = wait_generates(crash, f"{label} crash-loop")
            return (t_q, tp_q, broken, quarantined, still, crashed, moved,
                    wait_generates(moved, f"{label} moved"))

        (t_q, tp_q, broken, quarantined, still, crashed, moved,
         (moved_streams, _, _, _, moved_sides)) = counts.window(quarantine)
        check(broken and quarantined and still,
              f"{label} quarantine: broken {broken}, stats quarantined "
              f"{quarantined}, still broken after the moved wave was "
              f"issued {still}")
        held("crash-loop", crash_idx, crashed[0])
        held("moved", moved_idx, moved_streams)
        owners_hold("moved", dict(zip(moved_idx, moved_sides)),
                    moved=r0_fams)
        st0 = r0["sup"].stats()
        check(plan.injected.get(fault.STEP) == 3 and st0["restarts"] == 3,
              f"{label} quarantine: fault {plan.injected}, restarts "
              f"{st0['restarts']}")
        crash_t = r0["sup"]._restart_times[0]
        first_survivor = min(r.arrivals[0] for r in moved) - tp_q
        # -- revival: the probe revives R0 after the breaker's hold
        watcher.join(35)
        t_rev = revived["t"]
        check(not health_check.is_broken(r0["ep"])
              and not r0["sup"].stats()["quarantined"],
              f"{label}: R0 was not revived within 30 s")

        # -- cluster against one replica, warm, in alternating pairs
        # (these run inside the breaker's ramp after the revival)
        single = rpc.Channel(r0["addr"], timeout_ms=120_000)
        gen_tps = {"cluster": [], "single": []}
        # each engine's steps and step seconds in the pairs, by mode: a
        # replica's step costs host time per step, not per token
        steps = {m: [0, 0.0] for m in gen_tps}
        for k in range(REPLICA_PAIRS):
            for mode in (("cluster", "single") if k % 2 == 0
                         else ("single", "cluster")):
                engs = [r["sup"].engine for r in replicas]
                s0 = [(e.steps.get_value(), e.step_seconds) for e in engs]
                t, _, sides = counts.window(lambda: gen_pass(
                    cluster if mode == "cluster" else single,
                    f"{mode} pair", routed=mode == "cluster"))
                for e, (n0, sec0) in zip(engs, s0):
                    steps[mode][0] += e.steps.get_value() - n0
                    steps[mode][1] += e.step_seconds - sec0
                gen_tps[mode].append(toks / t)
                if mode == "single":
                    check(set(sides.values()) == {r0["addr"]},
                          f"{label} single: served by {set(sides.values())}")
        # -- after the ramp, R0's families route back to R0
        ramp_left = t_rev + CircuitBreaker.RECOVERY_WINDOW_S \
            - time.monotonic()
        if ramp_left > 0:
            time.sleep(ramp_left)
        _, _, sides = counts.window(lambda: gen_pass(cluster, "route back",
                                                     idx_waves=waves[:1]))
        owners_hold("route back", sides)
        for r in replicas:
            check(r["sup"].join_idle(30),
                  f"{label}: {r['name']} did not go idle")
            live = r["store"].stats()["live_seqs"]
            check(live == 0, f"{label}: {live} sequences live on "
                             f"{r['name']}")
        isolations = {r["name"]: breaker.isolation_count(r["ep"])
                      for r in replicas}
    finally:
        for r in replicas:
            r["server"].stop()
            r["server"].join()
        for r in replicas:
            r["sup"].close()
            r["batcher"].close()
            r["store"].clear()
        health_check.reset_all()
        health_check.health_check_interval_s = interval0
    for r in replicas:
        check(r["store"].pagepool.blocks_leased() == 0 and
              r["store"].pagepool.pool.stats()["classes"] == r["free0"],
              f"{label}: {r['name']}'s page pool did not return to its "
              f"baseline")
    check_rings(label, rings0)
    check(not lockprof.order_violations(),
          "lock-order violations:\n" + lockprof.witness_report())
    check(counts.paged > 0 and counts.paged_cuda == 2 * counts.paged
          and counts.flash > 0,
          f"{label}: {counts.paged} paged calls ({counts.paged_cuda} CUDA), "
          f"{counts.flash} flash calls")
    med = {k: pct(v, 50) for k, v in gen_tps.items()}
    smed = {k: pct(v, 50) for k, v in score_rps.items()}
    return {
        "config": label, "card": card, "families": len(families),
        "family_size": FAMILY_SIZE, "prompt_len": len(prompts[0]),
        "head_tokens": FAMILY_HEAD, "new_tokens": NEW_TOKENS,
        "owners": [f["owner"] for f in families],
        "cold_tokens_per_s": toks / t_cold,
        "warm_tokens_per_s": toks / t_warm,
        "warm_hit_tokens_per_replica": dict(zip(
            [r["name"] for r in replicas], hit_warm)),
        "cold_hit_tokens_per_replica": dict(zip(
            [r["name"] for r in replicas],
            [c - b for c, b in zip(hit_cold, hit_before)])),
        "warm_min_prefix_hit": min(hits.values()),
        "pair_tokens_per_s": gen_tps, "pair_tokens_per_s_median": med,
        "cluster_over_single": med["cluster"] / med["single"],
        "pair_steps": {m: v[0] for m, v in steps.items()},
        "pair_mean_step_ms": {m: 1e3 * v[1] / max(1, v[0])
                              for m, v in steps.items()},
        "crash_to_quarantine_ms": 1e3 * (t_q - crash_t),
        "quarantine_to_first_survivor_token_ms": 1e3 * first_survivor,
        "quarantine_to_revival_ms": 1e3 * (t_rev - t_q),
        "restarts": st0["restarts"], "isolation_counts": isolations,
        "score_rows_per_s": score_rps, "score_rows_per_s_median": smed,
        "score_fanned_over_single": smed["fanned"] / smed["single"],
        "backup": {"issued": bcntl.retried_count,
                   "from": bcntl.remote_side, "ms": 1e3 * t_backup},
        "refs_s": t_refs,
        "wall_s": time.perf_counter() - t_phase,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
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

    import brpc_tpu_torch._core.build as cbuild
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.ops._build as kbuild
    import brpc_tpu_torch.ops.attention as attn
    import brpc_tpu_torch.ops.paged_attention as pa
    # the native host core (g++, one process per source) builds while
    # nvcc builds the kernels (one process per source)
    native = {}

    def build_native():
        try:
            native["dir"] = cbuild.build()
        except Exception as e:           # re-raised below, on this thread
            native["error"] = e

    t_start = t0 = time.perf_counter()
    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    kbuild.build()
    build_s = time.perf_counter() - t0
    native_thread.join()
    if "error" in native:
        raise SmokeError(f"native core build failed: {native['error']}")
    print(f"native core: {native['dir']} built in "
          f"{cbuild.build_seconds} s", flush=True)
    import brpc_tpu_torch.native_path as native_path
    rings0 = native_path.tokring_live()
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
    # wall seconds of each phase: what each costs the script
    phase_s = {"build": time.perf_counter() - t_start}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

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
        # the engine's verify: 8 slots x (4 drafts + 1), draft trees and
        # padded rows
        run_paged(dev, "b verify N40 MP16 T16 +local tree", cfg_b,
                  page_tokens=16, n=40, mp=16, prefill=False,
                  extra="local_block", seed=7, prompt_len=200, w=5,
                  tree=True),
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
        # Serving.Score's batches: max batch 8 at the 256 length bucket
        run_flash(dev, "b score B8 S256 H8/4 D128 f32 causal", 8, 256, 8, 4,
                  128, "float32"),
        run_flash(dev, "bench B4 S4096 H8 D128 f32", 4, 4096, 8, 8, 128,
                  "float32"),
        run_flash(dev, "bench B4 S4096 H8 D128 bf16", 4, 4096, 8, 8, 128,
                  "bfloat16"),
    ]
    for row in flash:
        check(row["cuda_launches_per_call"] == 1,
              f"{row['shape']}: {row['cuda_launches_per_call']} CUDA "
              f"launches per call ({row['device_ops']}), not 1")
    for row in paged + flash:
        print(f"kernel {row['shape']}: err {row['max_abs_err']:.3g} "
              f"device ms {row['ms']:.4f} (eager "
              f"{row['eager_ms']:.4f}) plain {row['plain_ms']:.4f} library "
              f"{row['library_ms']} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row['bound_rate']}) achieved "
              f"{row['achieved']}, {100 * row['share_of_bound']:.1f}% of "
              f"bound, {row['cuda_launches_per_call']} CUDA launches/call",
              flush=True)

    phase_done("kernels")
    # -- serving phase, twice
    _, served_a = serve(dev, "a", cfg_a, page_tokens=4, num_slots=4,
                        max_pages=32, max_blocks=32, prompt_len=64,
                        buckets=(16, 64, 256), seed=11)
    ctx_b, served_b = serve(dev, "b", cfg_b, page_tokens=16, num_slots=8,
                            max_pages=16, max_blocks=64, prompt_len=200,
                            buckets=(16, 64, 256), seed=12)
    check_rings("serve a, b", rings0)
    phase_done("serve a, b")
    served = [served_a, served_b]
    for r in served:
        print(f"serve {r['config']}: cold {r['cold_tokens_per_s']:.1f} tok/s"
              f" warm {r['warm_tokens_per_s']:.1f} tok/s, mean step "
              f"{r['mean_step_ms']:.3f} ms, peak "
              f"{r['peak_memory_bytes'] / 2**20:.1f} MiB (+"
              f"{r['peak_memory_added_bytes'] / 2**20:.1f}), warm hit "
              f"{r['warm_prefix_hit_tokens']} tokens, launches "
              f"{r['launches']}, device busy (profiled warm pass) "
              f"{r['warm_profile']['device_busy_share']}", flush=True)

    # -- speculative serving phase: (b), its prompts and oracle, twice
    import brpc_tpu_torch.serving.speculative as spec
    speculative = [
        serve_spec(dev, "b spec ngram", cfg_b, ctx_b, spec.NGramProposer(),
                   draft_len=4),
        serve_spec(dev, "b spec draft-model", cfg_b, ctx_b,
                   spec.DraftModelProposer(ctx_b["params"], cfg_b, width=2),
                   draft_len=4),
    ]
    check_rings("serve spec", rings0)
    phase_done("serve spec")
    drafted = speculative[1]
    check(drafted["tokens_per_verify"] > 1,
          f"draft model: {drafted['tokens_per_verify']} tokens per verify")
    check(drafted["forks"] > 0, "draft model: the tree took no fork")
    check(drafted["launches"]["flash_attention"] > 0,
          "draft model: the flash kernel was not launched")
    for r in speculative:
        print(f"serve {r['config']}: cold {r['cold_tokens_per_s']:.1f} tok/s"
              f" warm {r['warm_tokens_per_s']:.1f} tok/s (plain b: cold "
              f"{served_b['cold_tokens_per_s']:.1f}, warm "
              f"{served_b['warm_tokens_per_s']:.1f}), mean step "
              f"{r['mean_step_ms']:.3f} ms (plain b "
              f"{served_b['mean_step_ms']:.3f}), verify "
              f"{r['mean_verify_ms']:.3f} ms, propose "
              f"{r['mean_propose_ms']:.3f} ms per verify, accept rate "
              f"{r['accept_rate']:.3f}, tokens per verify "
              f"{r['tokens_per_verify']:.3f}, verify calls "
              f"{r['verify_calls']}, forks {r['forks']}, launches "
              f"{r['launches']} ({r['paged_cuda_launches']} paged CUDA), "
              f"device busy (profiled warm pass) "
              f"{r['warm_profile']['device_busy_share']} (plain b "
              f"{served_b['warm_profile']['device_busy_share']})",
              flush=True)

    # -- RPC serving phase: (b) behind Serving.Generate on the port's server
    served_rpc = serve_rpc(dev, cfg_b, ctx_b, card)
    check_rings("serve rpc", rings0)
    phase_done("serve rpc")
    r = served_rpc
    print(f"serve b rpc [{card}]: cold {r['cold_tokens_per_s']:.1f} tok/s, "
          f"warm {r['warm_tokens_per_s']:.1f} tok/s (client in its own "
          f"process {r['client_process_warm_tokens_per_s']:.1f}); "
          f"{RPC_PAIRS} alternating warm pairs on the same engine: median "
          f"tok/s {json.dumps(r['pair_tokens_per_s_median'])}, median step "
          f"ms {json.dumps(r['pair_step_ms_median'])}, RPC/direct quartiles "
          f"{json.dumps(r['pair_rpc_over_direct_quartiles'])}, RPC ahead in "
          f"{r['pair_rpc_wins']} (plain b phase: cold "
          f"{served_b['cold_tokens_per_s']:.1f}, warm "
          f"{served_b['warm_tokens_per_s']:.1f}); spec ngram "
          f"{r['spec_tokens_per_s']:.1f} tok/s; time to first token ms "
          f"{json.dumps(r['ttft_ms'])}; inter-token gap ms "
          f"{json.dumps(r['gap_ms'])}; native core build "
          f"{r['native_build_s']} s; launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)

    # -- control-plane phase: Score through the batcher, the supervisor
    served_control = serve_control(dev, cfg_b, ctx_b, card)
    check_rings("serve control", rings0)
    phase_done("serve control")
    r = served_control
    sc, cr, cs = r["score"], r["crashed"], r["crashed_spec"]
    print(f"serve b control [{card}]: score {sc['rows']} rows in "
          f"{sc['batches']} batches, {sc['rows_per_s']:.1f} rows/s, avg "
          f"batch {sc['avg_batch_size']}, pad waste "
          f"{sc['pad_waste_ratio']}, queue delay p50/p99 "
          f"{sc['queue_delay_p50_us']:.0f}/{sc['queue_delay_p99_us']:.0f} "
          f"us, client latency ms {json.dumps(sc['latency_ms'])}, flash "
          f"calls {sc['flash_calls']}, device busy (profiled batch) "
          f"{sc['profile']['device_busy_share']}; prefix-cached score skip "
          f"{r['prefix_score']['prefix_skip_ratio']}; step crash: detect"
          f"->rebuild {cr['recovery'].get('detect_to_rebuild_ms')} ms, "
          f"->first resumed token "
          f"{cr['recovery'].get('detect_to_first_token_ms')} ms, crashed "
          f"pass {cr['tokens_per_s']:.1f} tok/s against uncrashed "
          f"{r['uncrashed_tokens_per_s']:.1f}, readmitted "
          f"{cr['readmitted']} ({cr['readmit_hit_tokens']} hit tokens); "
          f"spec verify crash: detect->rebuild "
          f"{cs['recovery'].get('detect_to_rebuild_ms')} ms, ->first "
          f"resumed token {cs['recovery'].get('detect_to_first_token_ms')}"
          f" ms, {cs['tokens_per_s']:.1f} tok/s; brownout "
          f"{json.dumps(r['brownout'])}; launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)

    # -- host-path phase: the native hot path on and off, rpcz, locks
    served_host = serve_host_path(dev, cfg_b, ctx_b, card)
    phase_done("serve host path")
    r = served_host
    fp, sm = r["flag_pairs"], r["score_medians"]
    print(f"serve b host [{card}]: native hot path on/off, {HOST_PAIRS} "
          f"alternating pairs each: direct median tok/s "
          f"{json.dumps(fp['direct']['tokens_per_s_median'])} quartiles "
          f"{json.dumps(fp['direct']['tokens_per_s_quartiles'])} median "
          f"step ms {json.dumps(fp['direct']['step_ms_median'])} quartiles "
          f"{json.dumps(fp['direct']['step_ms_quartiles'])} on/off "
          f"quartiles {json.dumps(fp['direct']['on_over_off_quartiles'])} "
          f"on ahead {fp['direct']['on_ahead']}; rpc median tok/s "
          f"{json.dumps(fp['rpc']['tokens_per_s_median'])} quartiles "
          f"{json.dumps(fp['rpc']['tokens_per_s_quartiles'])} median step "
          f"ms {json.dumps(fp['rpc']['step_ms_median'])} quartiles "
          f"{json.dumps(fp['rpc']['step_ms_quartiles'])} on/off quartiles "
          f"{json.dumps(fp['rpc']['on_over_off_quartiles'])} on ahead "
          f"{fp['rpc']['on_ahead']}", flush=True)
    print(f"serve b host score [{card}]: {SCORE_PAIRS} pairs, median "
          f"rows/s and batch time EMA ms by flag {json.dumps(sm)}",
          flush=True)
    print(f"serve b host rpcz [{card}]: traced Generate "
          f"{json.dumps(r['generate_tree'])}; span kinds "
          f"{json.dumps(r['span_kinds'])}; tok/s rpcz on/off medians "
          f"{json.dumps(r['traced_tokens_per_s_median'])} (all "
          f"{json.dumps(r['traced_tokens_per_s'])}); crashed pass "
          f"{r['crash_tokens_per_s']:.1f} tok/s, {r['crash_traces_linked']} "
          f"traces with both attempts linked", flush=True)
    print(f"serve b host hostcpu [{card}]: us per token by stage "
          f"{json.dumps(r['hostcpu_us_per_token'])}", flush=True)
    print(f"serve b host locks [{card}]: top 5 by wait "
          f"{json.dumps(r['top_lock_waits'])}; lock-order violations 0; "
          f"launches {r['launches']} ({r['paged_cuda_launches']} paged "
          f"CUDA)", flush=True)

    # -- replicas phase: two replicas behind the port's cluster channel
    served_replicas = serve_replicas(dev, cfg_b, ctx_b, card)
    phase_done("serve replicas")
    r = served_replicas
    print(f"serve b replicas [{card}]: cluster channel cold "
          f"{r['cold_tokens_per_s']:.1f} tok/s, warm "
          f"{r['warm_tokens_per_s']:.1f} tok/s; {REPLICA_PAIRS} alternating "
          f"warm pairs cluster/one replica median tok/s "
          f"{json.dumps(r['pair_tokens_per_s_median'])} (all "
          f"{json.dumps(r['pair_tokens_per_s'])}), cluster/single "
          f"{r['cluster_over_single']:.3f}, engine steps "
          f"{json.dumps(r['pair_steps'])} at mean ms "
          f"{json.dumps(r['pair_mean_step_ms'])}; warm hit tokens per replica "
          f"{json.dumps(r['warm_hit_tokens_per_replica'])} (cold "
          f"{json.dumps(r['cold_hit_tokens_per_replica'])}), least warm "
          f"prefix hit {r['warm_min_prefix_hit']}", flush=True)
    print(f"serve b replicas quarantine [{card}]: crash -> quarantine "
          f"{r['crash_to_quarantine_ms']:.1f} ms, -> first token on the "
          f"survivor {r['quarantine_to_first_survivor_token_ms']:.1f} ms, "
          f"quarantine -> revival {r['quarantine_to_revival_ms']:.1f} ms, "
          f"restarts {r['restarts']}, isolation counts "
          f"{json.dumps(r['isolation_counts'])}", flush=True)
    print(f"serve b replicas score [{card}]: {SCORE_FAN_PAIRS} alternating "
          f"pairs, median rows/s {json.dumps(r['score_rows_per_s_median'])}"
          f" (all {json.dumps(r['score_rows_per_s'])}), fanned/single "
          f"{r['score_fanned_over_single']:.3f}; backups issued "
          f"{r['backup']['issued']} (answered by {r['backup']['from']} in "
          f"{r['backup']['ms']:.1f} ms); phase wall {r['wall_s']:.1f} s "
          f"(references {r['refs_s']:.1f} s); launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)
    print(f"phase seconds [{card}]: {json.dumps(phase_s)}", flush=True)

    def entry(name, source, replaces, rows, main_row):
        m = rows[main_row]
        err = max(r["max_abs_err"] for r in rows)
        launches = sum(r["launches"][name] for r in
                       served + speculative + [served_rpc, served_control,
                                               served_host,
                                               served_replicas])
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
              "brpc_tpu/ops/attention.py:82", flash, 2),
    ]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "sass": sass, "kernels": kernels,
              "serving": served, "speculative": speculative,
              "rpc_serving": served_rpc, "control_serving": served_control,
              "host_path_serving": served_host,
              "replicas_serving": served_replicas, "phase_s": phase_s,
              "native_build_s": cbuild.build_seconds,
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
