#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU and check them.

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
     the paged kernel launched on the way (launch counts reset just
     before each serving run and read just after it, before the oracle:
     the engine runs no dense forward); then one more warm pass under
     ``torch.profiler`` for the device's busy share;
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
     baseline (``native_path.tokring_live``);
 11. flagship train step: the parameter-server model
     (``models/parameter_server.py``) at the width of the repo's own TPU
     run (vocab 32768, d_model 1024, d_ff 4096, 8 layers, seq 1024,
     batch 8), f32 master weights from a seed on the card, bf16 compute,
     TF32 off: step 1's loss and gradients at bf16 against the same step
     at f32 (loss within 1e-3 of its value, all gradients as one vector
     within 5e-2 of their norm), then 10 ``train_step``s (lr 0.1) on the
     fixed example batch, whose loss must fall from step 1 to step 10;
     prints the warm step's ms (CUDA events), tokens/s, TFLOP/s against
     the bf16 bound (6.18 TFLOP a step at 989 TFLOP/s), and the device's
     busy share and top kernels of a profiled step;
 12. PS fleet: the flagship's ``embed`` (32768 x 1024 f32, x100 and
     rounded to integers so that no order of float additions can change
     a bit) on 4 ``EmbeddingShardServer``s on the card, each behind its
     own port ``Server`` with ``register_psserve`` (key buckets up to
     4096), a ``PartitionChannel`` of 4 and a tensorframe ``PSClient``
     in front; 8192-key waves (one flagship batch's tokens) with
     integer grads: the lookup equals the dense table, a plain update,
     an sgdm update and an Adam update leave the fleet's rows and slots
     bit-equal to ``oracle_apply`` on a dense copy on the card, the Adam
     wave replayed under its ``update_token`` acks the original versions
     and changes nothing, no stale read; prints lookups/s and waves/s
     (client-timed p50/p99) and, at one shard's shapes, the device ms,
     CUDA launches and bytes bound of the gather, the scatter-add and
     ``fused_apply`` per kind at the 4096 bucket;
 13. trainer through the wire: ``DataParallelTrainer`` (vocab 1024,
     d_model 32, d_ff 64, 2 layers, seq 16, batch 8; 2 shards, 4
     workers, Adam lr 0.01, 8 steps, ``eval_every=4``): the Pull-based
     eval loss falls, no stale read, 32 waves; again with 3
     ``fault.UPDATE_WAVE`` failures and 2 dropped acks after the fused
     apply (``fault.PS_OPT_APPLY``, stage post): every wave applied
     exactly once (each shard's version = its updates + pushes, one
     fused apply per wave); then bench.py's training rung, 3
     alternating pairs of 2 s of ``_send_wave`` from 4 workers at vocab
     65536 (2048-key Adam waves), ``wire`` against
     ``pull_compute_push`` (updates/s and their ratio), and one JSON
     ``Pull`` of ``w_out`` at that width, which is why the trainer runs
     at vocab 1024 (its dense params ride JSON every step);

 14. KV migration and disaggregated serving, the wide configuration
     with step 4's weights, seed, prompts and oracle (page_tokens 16: 12
     full pages, 6 MiB, a 200-token prompt); every replica its own
     store, ``TransformerRunner``, block pool and ``Server(enable_dcn=
     True)``.  Migration: the 8 prompts served cold on R0, then
     ``PageMigrator.migrate``d to R1: every imported page equal to its
     source byte for byte, R1's ``Serving.Generate`` prefix-hits >= 192
     tokens with every stream the oracle's, a second migrate ships no
     new chunk, one ``fault.MIGRATE_SPLICE`` rolls back whole (R1's
     pages in use unchanged); the page stack's and the splice's device
     rows.  Prefix fetch: a cold R2 with a ``prefix_fetcher`` serves
     the prompts cold, then (store cleared) with ``prefix_holders=
     [R0]``: it fetches, hits >= 192, same streams; TTFT of both, all 8
     streams at once (each fetch waits on this process's own ``OfferT``
     and ``PushTo``: the fetch and the push run off the executor).  Rebalance: a ``PrefixAffinityLB`` over {R0}
     with ``migrate_on_rebalance(rebalance_pusher())`` routes step 9's
     4 prefix families (2 prompts each) to R0; adding R1 pushes the
     remapped families' pages, whose warm Generates on R1 hit >= 144.
     Disagg across two processes: the decode replica (store,
     ``EngineSupervisor``, ``register_disagg_decode``) in a child
     process (``brpc_tpu_torch.examples.disagg --role decode``) that
     builds the same weights from the seed, the prefill replica
     (``register_disagg_prefill(runner=)``) here, a
     ``DisaggCoordinator``: one generation under ``fault.MIGRATE_SEND``
     takes the recompute fallback, then 8 concurrent 32-token
     generations, every stream the oracle's, the decode side's hit
     covering the migrated pages, the paged kernel launched here; a
     profiled pass of the family prompts.  Failover: a primary with
     ``commit_live_pages=True`` under ``StandbySync`` to a standby (an
     ``EngineSupervisor``), its engine crashed mid-generation
     (``fault.STEP``) and closed; the client's ``assume_stream`` with
     its cursor completes the stream exactly once, equal to the oracle,
     the resume prefix-hitting shipped pages; a second assume refused.
     After every part: no live sequence, every pool at its baseline
     after ``clear()``, no DCN offer pinned (vacuous until the port has
     a transfer fabric: nothing on the host-serialized path offers),
     and (at the end) the native rings at their baseline.  Prints migrate ms p50/p99 a prompt,
     pages/s, MiB/s, splice p99, the host-serialized bytes and zero-copy
     count (0: the port has no transfer fabric), the fetch's TTFT
     against a cold prefill's, disagg TTFT and tokens/s beside step 6's
     RPC numbers, crash -> first resumed token, and the device rows;

 15. the HTTP face and the console, the wide configuration with step
     4's weights, prompts and oracle, one ``Server`` with its builtin
     console, ``register_serving(batcher=, engine=)`` and the chunked
     ``/serving/generate`` route: 8 concurrent 32-token streams through
     the port's ``HttpChannel.request_stream`` cold and warm (prefix
     hit, identical tokens) and with the native hot path off; one
     client dropped at its first token (the engine retires the slot:
     its terminal wraps EFAILEDSOCKET; nothing left live); 8 rows of
     ``POST /Serving/Score`` through the RESTful bridge into the
     batcher (the flash kernel), equal to the unbatched forward, then
     3 alternating REST/ScoreT pairs; the console under load (a warm
     pass with rpcz on while ``/status``, ``/vars``, ``/brpc_metrics``
     (Prometheus text parsed), ``/rpcz`` (the engine's decode spans),
     ``/serving``, ``/kvcache``, ``/hotspots`` (stage-tagged samples)
     and ``/hotspots/locks`` are read over and over, each timed);
     ``/flags`` sets and reads back ``rpcz_enabled``; 5 alternating
     warm HTTP/TRPC pairs on the same engine; 5 alternating pairs with
     ``hotspot_sampler_enabled`` off and on (flipped on ``/flags``);
     every console route 200, or 501 for the pages whose module the
     port lacks; the pool at its baseline and the sampler stopped
     after the server joins.  Prints tokens/s and TTFT p50/p99 HTTP
     against TRPC (and step 6's), REST Score rows/s and latency
     against ScoreT (and step 7's), the console scrape's p50/p99 and
     the sampler's on/off tokens/s;

 16. request dumps and replay, the span database and the flight
     recorder, the wide configuration with step 4's weights, prompts
     and oracle, one ``Server`` (``register_serving(batcher=,
     engine=)``) with ``rpc_dump`` at ratio 1, rpcz with
     ``rpcz_database_dir`` and the flight recorder on (dumps and span
     segments under ``build/capture/``): 8 traced 32-token
     ``Serving.Generate`` streams over TRPC (K1) and a ``ScoreT`` batch
     of 8 rows at S256 (K2).  The dump holds one record a request, each
     meta decoding to the call made.  The in-memory span ring cleared,
     ``load_disk_spans`` and ``/rpcz?trace_id=`` give each Generate's
     tree as it was ((kind, service, method, parent) equal, the page
     text equal).  ``/flightrecorder?fmt=json`` read twice during a
     warm pass names live ``worker/`` and ``epoll/`` threads whose
     event counts advance, and syscall counters above 0.  The dump
     replayed (``run_replay``) against a second ``Server`` with the same
     weights: 0 errors; each ``ScoreT`` record replayed again alone
     answers its original rows (max abs diff printed, ids equal to the
     unbatched forward); each ``Generate`` record, replayed without a
     client stream, is accepted and decodes to its end.  Then 5 pairs
     of warm 8-stream passes with all three off and on, the order
     alternating (tokens/s, on/off median; printed, not gated);

 17. the cluster front door, the wide configuration with step 4's
     weights, prompts and oracle: two replicas in this process (each a
     store with live page commits, a ``TransformerRunner``, an engine
     of 8 slots and a ``Server`` with ``Serving``, ``_kvmig``,
     ``_cluster`` and ``_telemetry``) behind a ``ClusterRouter``
     (``replicate_sessions``, a session WAL in a temporary directory,
     address-only replicas: floors ride ``_cluster``) on its own
     ``Server``, clients ``RouterClient``s.  8 concurrent 32-token
     sessions cold and warm, every stream the oracle's and each
     repeated prefix on its first replica; 2 alternating warm pairs
     through the router and straight to one replica (tokens/s, TTFT
     p50) and one router pass with the fleet-telemetry pulls off; the
     gradient forced to level 3: both replicas' floors and
     engine clamps follow over ``_cluster``, a new session gets ELIMIT
     with ``retry_after_s``, and all clears; a replica killed after 8
     tokens (``server.stop()``, ``engine.close()``) while the client
     drops: the session resumes on the other replica, the client's
     reconnect from its cursor completes the dense oracle's stream
     (computed before, outside the counted windows) with
     ``re_decoded_tokens`` below the total;
     then the router as its own process (``router_proc.spawn_router``)
     in front of the survivor and a fresh replica, 4 sessions,
     ``SIGKILL`` after 8 tokens each, a successor over the same WAL at
     a higher epoch adopts them and each client resumes exactly once
     from its cursor.  Both routers keep the default overload ladder,
     whose pool pressure counts the pages live sequences hold (a warm
     cache is not pressure).  Every pool back at its baseline, no
     stream or emit ring leaked.  The routed path runs K1 only: every
     replica's prefill, decode and resume; Generate reaches no dense
     forward.  Prints tokens/s and TTFT against direct, the kill ->
     first resumed token stall, the router restart's, and the buddy
     pushes and their pages;

and prints ``{"kernels": [...]}`` (K1 and K2: the PS and training
phases run torch ops only), the card line, and as the LAST line
``{"ok": true, "device": {...}}``.

Any failed check, build or launch exits non-zero before the result.
TF32 is off for every f32 matmul and convolution.  The full record of
the run goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import io
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


# profiler windows that ``launches_per_call`` took again because the
# profiler saw no device event in them at all; printed with the kernels
BLIND_WINDOWS = [0]


def launches_per_call(fn, tries=3):
    """CUDA kernels (and copies) one call of ``fn`` puts on the device,
    counted by ``torch.profiler`` over one warm call; "not measured"
    where the profiler saw no device activity.  The profiler has been
    seen to miss the first kernel of its window on the card, so each
    window opens with a marker (an int8 fill, which no wrapper here
    issues), dropped by position: only an event in the window's first
    place that carries the marker's name.  The count must be the same
    in at least 2 of ``tries`` windows; otherwise the counts of every
    window are returned, which no launch check accepts.  A window in
    which the profiler saw no device event at all, not even the marker
    (seen on the card, in the kernel phase, in two whole-script runs
    of ten), was not observed: it is taken again, at most
    ``2 * tries`` times, when it learns the marker's name and when it
    counts; each such window adds one to ``BLIND_WINDOWS``."""
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
    # twice: the marker's name is learned even if the first is missed;
    # a window in which the profiler saw nothing at all is taken again
    for _ in range(2 * tries):
        marker_name = device_names(lambda: (marker.fill_(1),
                                            marker.fill_(1)))[-1:]
        if marker_name:
            break
        BLIND_WINDOWS[0] += 1
    windows, blind = [], 0
    while len(windows) < tries:
        names = device_names(lambda: (marker.fill_(1), fn()))
        if not names and blind < 2 * tries:
            # the profiler saw no device event at all, not even the
            # marker: it did not observe this window; take it again
            blind += 1
            BLIND_WINDOWS[0] += 1
            continue
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

def dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The profile's device-side rows (kernels, copies, fills) by name.
    Only those: a host operator's row (``aten::mm``) carries its kernels'
    device time as well, so summing every row counts each kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]


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
    events = device_events(prof)
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
        # read before the oracle: its dense forwards are not the path's
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": attn.flash_attention.launches}
        t0 = time.perf_counter()
        oracle = [models.dense_generate(params, cfg, p, NEW_TOKENS,
                                        device=dev) for p in prompts]
        t_oracle = time.perf_counter() - t0
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
        check(launches["paged_attention"] > 0,
              f"{label}: the paged kernel was not launched on the path: "
              f"{launches}")
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
    ctx = {"params": params, "seed": seed, "prompts": prompts,
           "oracle": oracle, "geometry": {"page_tokens": page_tokens, "num_slots": num_slots,
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


# ---- step 14: KV migration and disaggregated serving ----------------------

def migration_device_rows(dev, store, pages):
    """Device rows of the migration's torch ops at (b)'s pages: the
    source's page stack (one gather of the pages into one tensor), its
    copy to the host, the destination's copy of the payload to the card,
    and its splice (one device copy per page into fresh pages)."""
    import torch
    pool = store.pagepool
    n, pb = len(pages), pool.page_bytes
    stacked = pool.stack_pages(pages)
    host = stacked.cpu().numpy()
    # the gather alone is graph-replayed (its index's copy to the card
    # cannot be captured); the launches and eager time are the whole call
    arena = pool.arena()
    idx = torch.tensor([pool.flat_ids([p.pid])[0] for p in pages],
                       dtype=torch.int64, device=dev)
    d_ms, _ = measure(lambda: arena.index_select(0, idx))
    e_ms = time_ms(lambda: pool.stack_pages(pages))
    n_launch, _ = launches_per_call(lambda: pool.stack_pages(pages))
    fresh = [pool.alloc_page() for _ in range(n)]
    try:
        payload = pool.as_pages(host)

        def splice():
            for i, p in enumerate(fresh):
                pool.write_raw(p, payload[i])

        s_ms, s_eager = measure(splice)
        s_launch, _ = launches_per_call(splice)
        check(all(pool.read_raw(p).tobytes() == host[i].tobytes()
                  for i, p in enumerate(fresh)),
              "b migration rows: the splice is not byte-exact")
    finally:
        for p in fresh:
            pool.unref(p)
    d2h = time_ms(lambda: stacked.cpu())
    h2d = time_ms(lambda: torch.from_numpy(host).to(dev))
    rows = []
    for name, dev_ms, eager, launches in (
            ("page stack (gather)", d_ms, e_ms, n_launch),
            ("splice (page copies)", s_ms, s_eager, s_launch)):
        b = bound(2 * n * pb, 0, "float32", dev_ms)
        rows.append({"program": f"{name} {n} x {pb} B", "device_ms": dev_ms,
                     "eager_ms": eager, "cuda_launches_per_call": launches,
                     **b})
    rows.append({"program": f"stack to host {n * pb} B", "eager_ms": d2h,
                 "device_ms": "not measured (a copy over PCIe)"})
    rows.append({"program": f"payload to card {n * pb} B", "eager_ms": h2d,
                 "device_ms": "not measured (a copy over PCIe)"})
    return rows


def serve_migration(dev, cfg, ctx, card, single_rpc):
    """Step 14 (see the module docstring): the wide configuration's pages
    migrated between replicas, fetched by a cold one, pushed on a ring
    change, handed from a prefill replica to a decode process, and kept
    on a standby for a failover."""
    import brpc_tpu_torch.examples.disagg as dg
    import brpc_tpu_torch.fault as fault
    from brpc_tpu_torch import errors
    import brpc_tpu_torch.migrate as migrate
    import brpc_tpu_torch.migrate.plane as plane
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.native_path as native_path
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.ici import dcn
    from brpc_tpu_torch.ici.block_pool import BlockPool
    from brpc_tpu_torch.policy.load_balancer import (PrefixAffinityLB,
                                                     ServerNode)
    t_phase = time.perf_counter()
    label = "b migration"
    geo, params = ctx["geometry"], ctx["params"]
    prompts, oracle = ctx["prompts"], ctx["oracle"]
    pt = geo["page_tokens"]
    full = (len(prompts[0]) - 1) // pt * pt          # 192 at (b)
    counts = Counts()
    rings0 = native_path.tokring_live()
    # the decode process of the disagg part starts now: its CUDA context
    # and weights come up while the parts before it run
    child = dg.spawn("--role", "decode", "--config",
                     json.dumps(cfg.__dict__), "--seed", str(ctx["seed"]),
                     "--page-tokens", str(pt),
                     "--max-blocks", str(geo["max_blocks"]),
                     "--max-pages", str(geo["max_pages"]),
                     "--num-slots", str(geo["num_slots"]), "--supervised",
                     *(["--device", "cpu"] if dev.type == "cpu" else []))
    reps = []

    def replica(name, role="serve", *, fetch=False, live=False,
                decode_addr=None):
        """A replica on a block pool of its own: ``serve`` (the migration
        splice and Serving.Generate over an engine), ``standby`` (the
        standby services over a supervised engine) or ``prefill`` (the
        disagg prefill service over the runner, no engine)."""
        store = models.make_store_for(cfg, page_tokens=pt,
                                      max_blocks=geo["max_blocks"],
                                      pool=BlockPool(dev), name=name,
                                      commit_live_pages=live)
        runner = models.TransformerRunner(params, cfg, store=store,
                                          device=dev, name=name)

        def factory():
            return serving.DecodeEngine(
                runner=runner, store=store, num_slots=geo["num_slots"],
                max_pages_per_slot=geo["max_pages"],
                prefill_buckets=geo["buckets"], device=dev, name=name)

        server = rpc.Server(enable_dcn=True, dcn_device=str(dev))
        r = {"name": name, "store": store, "engine": None,
             "server": server,
             "free0": store.pagepool.pool.stats()["classes"]}
        if role == "standby":
            r["engine"] = serving.EngineSupervisor(
                factory, store=store, ladder=CALM_LADDER, name=name)
            r["standby"] = migrate.register_standby(server, store,
                                                    r["engine"], name=name)
        elif role == "prefill":
            r["prefill"] = migrate.register_disagg_prefill(
                server, store, decode_addr, runner=runner, name=name)
        else:
            r["engine"] = factory()
            migrate.register_migration(server, store)
            r["svc"] = serving.register_serving(server, engine=r["engine"])
        server.start("127.0.0.1", 0)
        r["addr"] = f"127.0.0.1:{server.port}"
        if fetch:
            r["svc"].prefix_fetcher = migrate.make_prefix_fetcher(
                migrate.PageMigrator(store, name=f"{name}_fetcher"),
                r["addr"])
        reps.append(r)
        return r

    def baseline(r, what):
        """No live sequence; the pool back at its baseline after clear();
        no offer pinned (vacuous until a transfer fabric offers)."""
        eng = r["engine"]
        check(eng is None or eng.join_idle(60),
              f"{label} {what}: {r['name']} not idle")
        live_n = r["store"].stats()["live_seqs"]
        check(live_n == 0, f"{label} {what}: {live_n} sequences live on "
                           f"{r['name']}")
        r["store"].clear()
        check(r["store"].pagepool.blocks_leased() == 0 and
              r["store"].pagepool.pool.stats()["classes"] == r["free0"],
              f"{label} {what}: {r['name']}'s pool is off its baseline")
        check(dcn.live_offer_count() == 0,
              f"{label} {what}: {dcn.live_offer_count()} offers pinned")

    def held(what, streams, want):
        for i, (got, w) in enumerate(zip(streams, want)):
            check(got == w, f"{label} {what}: request {i} streamed {got}, "
                            f"dense oracle {w}")

    def rpc_pass(r, ps, what, extra=None):
        """``ps`` through ``r``'s Serving.Generate, all at once: streams,
        prefix hits, client-timed TTFTs, wall seconds."""
        ch = rpc.Channel(r["addr"], timeout_ms=120_000)
        t0 = time.perf_counter()
        recs = issue_generates(ch, ps, extra=extra)
        streams, hits, ttft, _, _ = wait_generates(recs, f"{label} {what}")
        return streams, hits, ttft, time.perf_counter() - t0

    bytes0 = plane.migrate_bytes.get_value()
    fb0 = plane.migrate_fallback.get_value()
    zc0 = plane.migrate_zero_copy.get_value()
    try:
        r0, r1 = replica("b_mig0"), replica("b_mig1")
        # -- 1. migration R0 -> R1
        cold = counts.window(lambda: generate_all(r0["engine"], prompts,
                                                  f"{label} R0 cold"))
        held("R0 cold", cold, oracle)
        mig = migrate.PageMigrator(r0["store"], name="b_mig0_out")
        mig_ms, pages = [], 0
        for p in prompts:
            t0 = time.perf_counter()
            pages += mig.migrate(p, r1["addr"])
            mig_ms.append(1e3 * (time.perf_counter() - t0))
        route = mig.stats()["routes"][r1["addr"]]
        check(route["pages"] == pages == len(prompts) * (len(prompts[0])
                                                         // pt),
              f"{label}: {route} after migrating {pages} pages")
        def page_bytes(store, p):
            _, held_pages = store.acquire_pages(p)
            try:
                return [store.pagepool.read_raw(q).tobytes()
                        for q in held_pages]
            finally:
                store.release(held_pages)

        for p in prompts:
            got_b = page_bytes(r1["store"], p)
            check(got_b == page_bytes(r0["store"], p)
                  and len(got_b) == len(p) // pt,
                  f"{label}: an imported page differs from its source")
        streams, hits, ttft_mig, wall_mig = counts.window(
            lambda: rpc_pass(r1, prompts, "R1 from migrated pages"))
        held("R1 from migrated pages", streams, oracle)
        check(min(hits) >= full, f"{label}: R1 hits {hits} < {full}")
        again = sum(mig.migrate(p, r1["addr"]) for p in prompts)
        check(mig.stats()["routes"][r1["addr"]]["pages"] == pages
              and again == pages,
              f"{label}: a second migrate shipped new chunks")
        baseline(r1, "R1")
        in_use = r1["store"].pagepool.pages_in_use()
        plan = fault.FaultPlan(14).on(fault.MIGRATE_SPLICE, fault.ERROR,
                                      times=-1, after=1)
        with fault.injected(plan):
            try:
                migrate.PageMigrator(r0["store"], name="b_mig0_fault"
                                     ).migrate(prompts[0], r1["addr"])
                check(False, f"{label}: the splice fault did not fail")
            except errors.RpcError as e:
                check("splice" in e.text, f"{label}: splice fault: {e}")
        check(plan.injected[fault.MIGRATE_SPLICE] >= 1
              and r1["store"].pagepool.pages_in_use() == in_use
              and r1["store"].probe(prompts[0]) == 0,
              f"{label}: the faulted splice did not roll back whole")
        _, held_pages = r0["store"].acquire_pages(prompts[0])
        try:
            rows = migration_device_rows(dev, r0["store"], held_pages)
        finally:
            r0["store"].release(held_pages)
        baseline(r1, "after the splice fault")
        check_rings(f"{label} migrate", rings0)

        # -- 2. a cold replica fetches from its holder
        r2 = replica("b_mig2", fetch=True)
        s_cold, h_cold, ttft_cold, wall_cold = counts.window(
            lambda: rpc_pass(r2, prompts, "R2 cold"))
        held("R2 cold", s_cold, oracle)
        check(max(h_cold) == 0, f"{label}: R2 cold hit {h_cold}")
        baseline(r2, "R2 cold")
        holders = {i: {"prefix_holders": [r0["addr"]]}
                   for i in range(len(prompts))}
        # 8 fetching Generates at once, holder and fetcher in this one
        # process: each waits on R0's PushTo, which waits on R2's OfferT
        # (the fetch and the push run off the executor, so none times
        # out into a recompute)
        s_fetch, h_fetch, ttft_fetch, wall_fetch = counts.window(
            lambda: rpc_pass(r2, prompts, "R2 fetch", extra=holders))
        held("R2 fetch", s_fetch, oracle)
        check(min(h_fetch) >= full and r2["svc"].prefix_fetches
              == len(prompts), f"{label}: R2 fetched "
                               f"{r2['svc'].prefix_fetches}, hits {h_fetch}")
        baseline(r2, "R2 fetch")
        baseline(r0, "R0")
        check_rings(f"{label} fetch", rings0)

        # -- 3. migrate on rebalance: R1 joins a ring of R0
        eps = [str2endpoint(r["addr"]) for r in (r0, r1)]
        families = family_prompts(cfg, eps, seed=21)
        fam = [f["prompts"][:2] for f in families]
        fprompts = [p for f in fam for p in f]
        t0 = time.perf_counter()
        foracle = [models.dense_generate(params, cfg, p, NEW_TOKENS,
                                         device=dev) for p in fprompts]
        t_refs = time.perf_counter() - t0
        lb = PrefixAffinityLB()
        lb.migrate_on_rebalance(migrate.rebalance_pusher(120_000))
        lb.add_server(ServerNode(eps[0]))
        for p in fprompts:
            check(lb.select_for_prompt(p) == eps[0],
                  f"{label}: a one-replica ring routed off R0")
        streams = counts.window(lambda: generate_all(
            r0["engine"], fprompts, f"{label} R0 families"))
        held("R0 families", streams, foracle)
        lb.add_server(ServerNode(eps[1]))
        check(lb.join_migrations(120), f"{label}: rebalance hung")
        moved = [k for k, f in enumerate(families)
                 if f["owner"] == r1["addr"]]
        check(lb.remaps == len(moved) and lb.remap_failures == 0
              and lb.remap_migrations == len(moved),
              f"{label}: remaps {lb.remaps} (failed {lb.remap_failures}) "
              f"for families {moved}")
        idx = [2 * k + j for k in moved for j in range(2)]
        for i in idx:
            check(lb.select_for_prompt(fprompts[i]) == eps[1],
                  f"{label}: a remapped family still routes to R0")
        s_rb, h_rb, _, _ = counts.window(lambda: rpc_pass(
            r1, [fprompts[i] for i in idx], "R1 after the rebalance"))
        held("R1 after the rebalance", s_rb, [foracle[i] for i in idx])
        check(min(h_rb) >= FAMILY_HEAD - pt,
              f"{label}: rebalanced hits {h_rb} < {FAMILY_HEAD - pt}")
        for r in (r0, r1):
            baseline(r, "rebalance")
        check_rings(f"{label} rebalance", rings0)

        # -- 4. disagg: prefill here, decode in the child process
        dec_addr = f"127.0.0.1:{child[1]}"
        pre = replica("b_prefill", "prefill", decode_addr=dec_addr)
        co = migrate.DisaggCoordinator(pre["addr"], dec_addr, device=dev)
        ta, tb = co.pair()
        check(ta["platform"] == tb["platform"]
              == ("gpu" if dev.type == "cuda" else "cpu")
              and ta["pid"] != tb["pid"] and tb["xfer"] is None,
              f"{label}: pairing {ta} {tb}")

        def disagg_pass(ps):
            outs, firsts = [None] * len(ps), [None] * len(ps)
            t_issue = time.perf_counter()

            def run(i):
                def first(_t):
                    if firsts[i] is None:
                        firsts[i] = time.perf_counter() - t_issue
                outs[i] = co.generate(ps[i], NEW_TOKENS, emit=first,
                                      timeout_s=300)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(ps))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            return outs, firsts, time.perf_counter() - t_issue

        # first one generation whose page stream fails
        # (fault.MIGRATE_SEND): the decode side recomputes, and the
        # decode process's first device work is done before the timed pass
        disagg_counts = Counts()
        rng = np.random.default_rng(141)
        fb_prompt = rng.integers(0, cfg.vocab, len(prompts[0])).tolist()
        fb_oracle = models.dense_generate(params, cfg, fb_prompt,
                                          NEW_TOKENS, device=dev)
        plan = fault.FaultPlan(15).on(fault.MIGRATE_SEND, fault.ERROR,
                                      times=1)
        with fault.injected(plan):
            fb = disagg_counts.window(lambda: co.generate(
                fb_prompt, NEW_TOKENS, timeout_s=300))
        check(fb["error"] is None and fb["prefill"]["recompute_fallback"]
              and fb["prefix_hit"] == 0 and fb["tokens"] == fb_oracle,
              f"{label} disagg fallback: {fb['prefill']}, hit "
              f"{fb['prefix_hit']}, tokens equal "
              f"{fb['tokens'] == fb_oracle}")
        outs, firsts, wall_dg = disagg_counts.window(
            lambda: disagg_pass(prompts))
        # the family prompts, cold on both sides, under the profiler: the
        # prefill process's busy share (the decode process is not seen)
        (p_outs, _, _), prof = profile_window(
            lambda: disagg_counts.window(lambda: disagg_pass(fprompts)))
        held("disagg profiled", [o["tokens"] for o in p_outs], foracle)
        counts.paged += disagg_counts.paged
        counts.paged_cuda += disagg_counts.paged_cuda
        counts.flash += disagg_counts.flash
        for i, out in enumerate(outs):
            check(out is not None and out["error"] is None,
                  f"{label} disagg: generation {i} failed: {out}")
            check(out["prefill"]["migrated_pages"] == len(prompts[i]) // pt
                  and not out["prefill"]["recompute_fallback"]
                  and out["prefix_hit"] >= full,
                  f"{label} disagg: hand-off {out['prefill']}, decode hit "
                  f"{out['prefix_hit']}")
        held("disagg", [o["tokens"] for o in outs], oracle)
        check(disagg_counts.paged > 0,
              f"{label} disagg: the paged kernel was not launched in the "
              f"prefill process")
        child_stats = dg.stop(child[0])
        child = None
        check(child_stats["live_seqs"] == 0
              and child_stats["pool_at_baseline"]
              and child_stats["imported_pages"] >= len(prompts)
              * (len(prompts[0]) // pt),
              f"{label} disagg: the decode process ended with "
              f"{child_stats}")
        baseline(pre, "disagg prefill")
        check_rings(f"{label} disagg", rings0)

        # -- 5. failover to a standby
        sb = replica("b_standby", "standby")
        pr = replica("b_primary", live=True)
        sync = migrate.StandbySync(pr["store"], sb["addr"],
                                   submit_fn=pr["engine"].submit,
                                   name="b_sync")
        try:
            got, errs, done = [], [], threading.Event()
            t_crash = [0.0]

            def on_done(e):
                t_crash[0] = time.perf_counter()
                errs.append(e)
                done.set()

            crash_k = NEW_TOKENS // 2
            plan = fault.FaultPlan(16).on(
                fault.STEP, fault.ERROR, times=1, after=crash_k,
                match=lambda c: c.get("name") == "b_primary")
            with fault.injected(plan):
                sid, finished = counts.window(lambda: (sync.submit(
                    prompts[1], NEW_TOKENS, got.append, on_done),
                    done.wait(300)))
            check(finished, f"{label} failover: the primary hung")
            check(errs[0] is not None and len(got) == crash_k,
                  f"{label} failover: primary ended {errs[0]} after "
                  f"{len(got)} tokens")
            check(sync.flush(60), f"{label} failover: ship queue stuck")
            pr["engine"].close()                     # the primary dies
            t_first = []
            out = counts.window(lambda: migrate.assume_stream(
                sb["addr"], sid, len(got), timeout_s=300,
                emit=lambda t: t_first.append(time.perf_counter())))
            check(out["error"] is None and got + out["tokens"]
                  == oracle[1], f"{label} failover: stream differs")
            check(out["resume_prefix_hit"] > 0 and out["replayed"] == 0,
                  f"{label} failover: {out}")
            try:
                migrate.assume_stream(sb["addr"], sid, len(got))
                check(False, f"{label} failover: a second assume passed")
            except errors.RpcError as e:
                check(e.code == errors.EREQUEST,
                      f"{label} failover: second assume: {e}")
            sync_stats = sync.stats()
        finally:
            sync.close()
        failover_ms = 1e3 * (t_first[0] - t_crash[0])
        for r in (sb, pr):
            baseline(r, "failover")
    finally:
        if child is not None:
            child[0].kill()
            child[0].wait()
        for r in reps:
            r["server"].stop()
            r["server"].join()
        for r in reps:
            if r["engine"] is not None:
                r["engine"].close()
            r["store"].clear()
    for r in reps:
        check(r["store"].pagepool.blocks_leased() == 0,
              f"{label}: {r['name']}'s pool did not return to its baseline")
    check(dcn.live_offer_count() == 0, f"{label}: offers left pinned")
    check_rings(label, rings0)
    check(counts.paged > 0 and counts.paged_cuda == 2 * counts.paged,
          f"{label}: {counts.paged} paged calls ({counts.paged_cuda} CUDA)")
    mb = (plane.migrate_bytes.get_value() - bytes0) / 2**20
    mig_s = sum(mig_ms) / 1e3
    toks = len(prompts) * NEW_TOKENS
    return {
        "config": label, "card": card, "page_tokens": pt,
        "prompt_len": len(prompts[0]), "new_tokens": NEW_TOKENS,
        "pages_per_prompt": len(prompts[0]) // pt,
        "migrate_ms": {"p50": pct(mig_ms, 50), "p99": pct(mig_ms, 99),
                       "all": mig_ms},
        "migrate_pages_per_s": pages / mig_s,
        "migrate_mb_per_s": pages * r0["store"].pagepool.page_bytes
        / 2**20 / mig_s,
        "splice_p99_us": plane.splice_recorder().latency_percentile(0.99),
        "host_serialized_mb": mb,
        "fallback_migrations": plane.migrate_fallback.get_value() - fb0,
        "zero_copy": plane.migrate_zero_copy.get_value() - zc0,
        "r1_min_prefix_hit": min(hits),
        "r1_ttft_ms_p50": 1e3 * pct(ttft_mig, 50),
        "fetch_ttft_ms_p50": 1e3 * pct(ttft_fetch, 50),
        "cold_ttft_ms_p50": 1e3 * pct(ttft_cold, 50),
        "fetch_pass_s": wall_fetch, "cold_pass_s": wall_cold,
        "fetch_streams": len(prompts),
        "fetch_min_prefix_hit": min(h_fetch),
        "rebalance": {"families": len(families), "remapped": len(moved),
                      "min_prefix_hit": min(h_rb),
                      "remap_migrations": lb.remap_migrations},
        "disagg": {
            "ttft_ms_p50": 1e3 * pct([f for f in firsts if f], 50),
            "prefill_call_ms_p50": pct([o["prefill_ms"] for o in outs], 50),
            "tokens_per_s": toks / wall_dg,
            "single_replica_rpc_ttft_ms": single_rpc["ttft_ms"],
            "single_replica_rpc_tokens_per_s": {
                "cold": single_rpc["cold_tokens_per_s"],
                "warm": single_rpc["warm_tokens_per_s"]},
            "min_decode_prefix_hit": min(o["prefix_hit"] for o in outs),
            "prefill_paged_calls": disagg_counts.paged,
            "prefill_stats": pre["prefill"].stats(),
            "decode_process": child_stats,
            "profile": prof, "fallback_prefix_hit": fb["prefix_hit"]},
        "failover": {"crash_to_first_resumed_token_ms": failover_ms,
                     "tokens_before_crash": crash_k,
                     "resume_prefix_hit": out["resume_prefix_hit"],
                     "sync": sync_stats},
        "device_rows": rows, "refs_s": t_refs,
        "wall_s": time.perf_counter() - t_phase,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- step 15: the HTTP face and the console ------------------------------

HTTP_PAIRS = 5       # alternating warm HTTP/TRPC pairs
SAMPLER_PAIRS = 5    # hotspot_sampler_enabled off/on warm HTTP pairs
REST_PAIRS = 3       # RESTful Score / ScoreT pairs of 8 rows
# the pages read under load, and how each must parse
CONSOLE_PAGES = ("/status", "/vars", "/brpc_metrics", "/rpcz", "/serving",
                 "/kvcache", "/hotspots", "/hotspots/locks")
# the routes whose module the port lacks: 501, naming what brings them
NOT_PORTED_ROUTES = frozenset((
    "/ici", "/fleet", "/hotspots/cpu",
    "/hotspots/native", "/hotspots/contention", "/hotspots/heap",
    "/hotspots/growth", "/pprof/profile", "/pprof/profile_native",
    "/pprof/contention", "/pprof/heap", "/pprof/growth"))


def http_generate_all(port, prompts, label, cancel=None):
    """One chunked ``GET /serving/generate`` per prompt, all issued at
    once through the port's ``HttpChannel.request_stream``, each on its
    own connection; the client stamps each call's issue and each
    token's arrival.  ``cancel`` (an index): that client closes its
    connection at its first token.  Returns the streams, the time to
    first token and the inter-token gaps (seconds, the finished streams)
    and the wall time."""
    import brpc_tpu_torch.rpc as rpc
    recs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        rec = {"buf": b"", "toks": [], "arrivals": [], "end": None,
               "t_issue": time.perf_counter()}

        def on_data(data, rec=rec, i=i):
            now = time.perf_counter()
            rec["buf"] += data
            *lines, rec["buf"] = rec["buf"].split(b"\n")
            for ln in lines:
                d = json.loads(ln)
                if "token" in d:
                    rec["toks"].append(d["token"])
                    rec["arrivals"].append(now)
                    if cancel == i:
                        if "reader" in rec:
                            rec["reader"].cancel()
                        else:       # the token beat the assignment below
                            rec["cancel_now"] = True
                else:
                    rec["end"] = d

        rec["reader"] = rpc.HttpChannel(f"127.0.0.1:{port}").request_stream(
            "GET", f"/serving/generate?prompt={','.join(map(str, p))}"
                   f"&max_new_tokens={NEW_TOKENS}", on_data=on_data)
        if rec.pop("cancel_now", False):
            rec["reader"].cancel()
        recs.append(rec)
    for i, rec in enumerate(recs):
        check(rec["reader"].wait(300), f"{label}: stream {i} hung")
        if i == cancel:
            continue
        check(rec["reader"].error is None,
              f"{label}: stream {i} failed: {rec['reader'].error}")
        check(rec["end"] == {"done": True},
              f"{label}: stream {i} ended with {rec['end']}")
    wall = time.perf_counter() - t0
    done = [r for i, r in enumerate(recs) if i != cancel]
    ttft = [r["arrivals"][0] - r["t_issue"] for r in done if r["arrivals"]]
    gaps = [b - a for r in done
            for a, b in zip(r["arrivals"], r["arrivals"][1:])]
    return [r["toks"] for r in recs], ttft, gaps, wall


def rest_scores(port, rows, label):
    """Every row as one ``POST /Serving/Score`` through the RESTful
    bridge, all at once.  Returns ``[(row index, y)]``, the calls'
    client-timed latencies and the wall time."""
    import brpc_tpu_torch.rpc as rpc
    out = [None] * len(rows)
    lat, errs = [], []

    def one(i):
        try:
            ch = rpc.HttpChannel(f"127.0.0.1:{port}", timeout_ms=120_000)
            t0 = time.perf_counter()
            y = ch.call("Serving", "Score",
                        {"x": [float(t) for t in rows[i]]})["y"]
            lat.append(time.perf_counter() - t0)
            out[i] = (i, np.asarray(y, np.float32))
            ch.close()
        except Exception as e:
            errs.append(f"row {i}: {type(e).__name__}: {e}")

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(rows))]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    check(not errs and all(o is not None for o in out),
          f"{label}: {errs[:4] or 'a call hung'}")
    return out, lat, wall


def prometheus_families(text):
    """Every line of the scrape a comment or a sample, one TYPE per
    family; returns ``{family: type}``."""
    import re
    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
        r'([^"\\]|\\.)*",?)*\})? [-+0-9.eE]+(inf|nan)?$')
    fams = {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split(" ", 3)
            check(fam not in fams, f"/brpc_metrics: two TYPEs for {fam}")
            fams[fam] = kind
        elif ln and not ln.startswith("# HELP "):
            check(sample.match(ln), f"/brpc_metrics: bad line {ln!r}")
    return fams


def check_console_page(path, resp, engine_name, store_name):
    """One page read: 200, and it parses (``/rpcz`` must show the
    engine's decode spans: read it after the pass)."""
    import re
    check(resp.status == 200, f"console {path}: HTTP {resp.status} "
                              f"{resp.body[:300]!r}")
    text = resp.body.decode()
    if path == "/status":
        check("Serving.Generate: count=" in text, "/status: no Generate")
    elif path == "/vars":
        check(all(" : " in ln for ln in text.splitlines())
              and "gil_wait_ratio : " in text, "/vars malformed")
    elif path == "/brpc_metrics":
        fams = prometheus_families(text)
        check(fams.get("serving_ttft_us") == "summary"
              and fams.get("gil_wait_ratio") == "gauge",
              f"/brpc_metrics families: {sorted(fams)[:20]}")
    elif path == "/rpcz":
        check(f"decode Serving.{engine_name}" in text,
              "/rpcz shows no Generate (decode) span")
    elif path == "/serving":
        check(engine_name in json.loads(text)["engines"], "/serving")
    elif path == "/kvcache":
        check(store_name in json.loads(text)["stores"], "/kvcache")
    elif path == "/hotspots":
        m = re.search(r"RUNNING @ [0-9.]+Hz, \d+ windows x [0-9.]+s, "
                      r"(\d+) samples", text)
        check(m is not None and int(m.group(1)) > 0
              and "stage-tagged" in text, f"/hotspots: {text[:300]!r}")
    elif path == "/hotspots/locks":
        check("lock-contention ledger" in text or
              "no instrumented locks" in text, "/hotspots/locks")


def serve_http(dev, cfg, ctx, card, rpc_rec, control_rec):
    """Step 15 (see the module docstring): (b) behind one Server with
    its builtin console, ``Serving`` and the chunked
    ``/serving/generate`` route; step 4's weights, prompts and dense
    oracle."""
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.rpcz as rpcz
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch import errors, flags
    from brpc_tpu_torch.builtin.sampler import HotspotSampler
    from brpc_tpu_torch.builtin.services import build_routes
    geo, prompts, oracle = ctx["geometry"], ctx["prompts"], ctx["oracle"]
    params = ctx["params"]
    toks = N_REQUESTS * NEW_TOKENS
    counts = Counts()
    t_phase = time.perf_counter()
    # the checks' references, outside every counting window
    want = [unbatched_ids(params, cfg, dev, p) for p in prompts]
    label, eng_name, store_name = "b http", "b_http", "b_http_kv"

    class Terminals:
        """The engine as the routes see it: each generation's terminal
        error."""

        def __init__(self, engine):
            self.engine, self.store = engine, engine.store
            self.errs = []

        def submit(self, prompt, max_new, emit, on_done, **kw):
            def done(err):
                self.errs.append(err)
                on_done(err)
            return self.engine.submit(prompt, max_new, emit, done, **kw)

    def streams_equal(name, streams, skip=()):
        for i, (c, o) in enumerate(zip(streams, oracle)):
            if i not in skip:
                check(c == o, f"{label} {name}: stream {i} streamed {c}, "
                              f"dense oracle {o}")

    store = models.make_store_for(cfg, page_tokens=geo["page_tokens"],
                                  max_blocks=geo["max_blocks"], device=dev,
                                  name=store_name)
    free0 = store.pagepool.pool.stats()["classes"]
    runner = models.TransformerRunner(params, cfg, store=store, device=dev,
                                      name=label)
    engine = serving.DecodeEngine(
        runner=runner, store=store, num_slots=geo["num_slots"],
        max_pages_per_slot=geo["max_pages"], prefill_buckets=geo["buckets"],
        device=dev, name=eng_name)
    batcher = serving.DynamicBatcher(
        models.TransformerRunner(params, cfg, device=dev, name="b http score"),
        max_batch_size=8, max_delay_us=5000, length_buckets=(64, 256),
        dtype=np.int32, name="b_http_score")
    rec = Terminals(engine)
    server = rpc.Server()
    serving.register_serving(server, batcher=batcher, engine=rec)
    server.start("127.0.0.1", 0)
    port = server.port
    web = rpc.HttpChannel(f"127.0.0.1:{port}", timeout_ms=60_000)

    def flag(name, value):
        r = web.get(f"/flags?setvalue={name}&value={value}")
        check(r.status == 200 and r.body == b"ok\n",
              f"/flags {name}={value}: {r.status} {r.body!r}")

    def http_pass(name, **kw):
        out = counts.window(lambda: http_generate_all(port, prompts,
                                                      f"{label} {name}", **kw))
        streams_equal(name, out[0], skip={kw.get("cancel")})
        return out

    try:
        check(HotspotSampler.instance().running,
              "the hotspot sampler did not start with the server")
        # -- generate over HTTP, cold then warm, then the Python hot path
        hit0 = store.hit_tokens
        cold, ttft_c, gaps_c, t_cold = http_pass("cold")
        hit1 = store.hit_tokens
        warm, ttft_w, gaps_w, t_warm = http_pass("warm")
        check(warm == cold and store.hit_tokens - hit1 > 0,
              f"{label}: the warm pass hit {store.hit_tokens - hit1} tokens")
        flags.set_flag("native_hot_path_enabled", False)
        try:
            _, _, _, t_python = http_pass("native hot path off")
        finally:
            flags.set_flag("native_hot_path_enabled", True)
        check(counts.paged > 0, f"{label}: the paged kernel was not "
                                f"launched ({counts.as_dict()})")
        # -- a client gone mid-stream: the engine retires its slot
        n_err = len(rec.errs)
        http_pass("client gone", cancel=0)
        check(engine.join_idle(60), f"{label}: the engine did not go idle")
        gone = [e for e in rec.errs[n_err:] if e is not None]
        check(len(gone) == 1 and
              f"[E{errors.EFAILEDSOCKET}] http client gone" in gone[0].text,
              f"{label}: the dropped client's terminals: {gone}")
        check(store.stats()["live_seqs"] == 0,
              f"{label}: {store.stats()['live_seqs']} sequences live after "
              f"the dropped client")
        # -- Score over the RESTful bridge, then against ScoreT
        flash0 = counts.flash
        scored, _, _ = counts.window(lambda: rest_scores(
            port, prompts, f"{label} score"))
        hold_rows(f"{label} rest score", scored, want)
        check(counts.flash > flash0, f"{label}: the flash kernel was not "
                                     f"launched by the RESTful Score")
        score = {"rest": [], "scoret": []}
        for i in range(REST_PAIRS):
            for kind in ("rest", "scoret") if i % 2 == 0 \
                    else ("scoret", "rest"):
                if kind == "rest":
                    got, lat, wall = counts.window(lambda: rest_scores(
                        port, prompts, f"{label} rest pair"))
                else:
                    got, lat, wall = counts.window(lambda: score_calls(
                        port, prompts, N_REQUESTS, 0, f"{label} scoret pair"))
                    lat = lat["tensorframe"]
                hold_rows(f"{label} {kind} pair", got, want)
                score[kind].append((len(got) / wall, pct(lat, 50),
                                    pct(lat, 99)))
        # -- the console under load: a warm pass with rpcz on, the pages
        # read over and over while it runs (never a /hotspots burst)
        flag("rpcz_enabled", "true")
        check(rpcz.enabled() and
              b"rpcz_enabled=True" in web.get("/flags").body,
              "/flags: rpcz_enabled did not read back")
        loaded = {}
        th = threading.Thread(target=lambda: loaded.update(
            out=http_generate_all(port, prompts, f"{label} loaded")))
        scrapes, read = [], []
        th.start()
        while True:
            for path in CONSOLE_PAGES:
                t0 = time.perf_counter()
                read.append((path, web.get(path)))
                scrapes.append(time.perf_counter() - t0)
            if not th.is_alive():
                break
        th.join()
        check("out" in loaded, f"{label}: the loaded pass failed")
        streams_equal("loaded", loaded["out"][0])
        for path, resp in read:
            if path != "/rpcz":
                check_console_page(path, resp, eng_name, store_name)
            else:
                check(resp.status == 200, f"/rpcz: HTTP {resp.status}")
        # the pass's decode spans land as its requests retire
        deadline = time.monotonic() + 5
        while True:
            resp = web.get("/rpcz")
            if f"decode Serving.{eng_name}".encode() in resp.body \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check_console_page("/rpcz", resp, eng_name, store_name)
        flag("rpcz_enabled", "false")
        # -- warm HTTP against TRPC on the same engine, alternating
        pairs = {"http": [], "trpc": []}
        for i in range(HTTP_PAIRS):
            for kind in ("http", "trpc") if i % 2 == 0 else ("trpc", "http"):
                if kind == "http":
                    streams, ttft, gaps, wall = http_pass("pair")
                else:
                    streams, _, ttft, gaps, wall = counts.window(
                        lambda: rpc_generate_all(port, prompts,
                                                 f"{label} trpc pair"))
                    streams_equal("trpc pair", streams)
                pairs[kind].append((toks / wall, pct(ttft, 50),
                                    pct(ttft, 99)))
        # -- the always-on sampler off against on, alternating
        sampler = {"off": [], "on": []}
        for i in range(SAMPLER_PAIRS):
            for kind in ("off", "on") if i % 2 == 0 else ("on", "off"):
                flag("hotspot_sampler_enabled",
                     "false" if kind == "off" else "true")
                check(HotspotSampler.instance().running == (kind == "on"),
                      f"{label}: the sampler did not turn {kind}")
                _, _, _, wall = http_pass(f"sampler {kind}")
                sampler[kind].append(toks / wall)
        flag("hotspot_sampler_enabled", "true")
        # what one pass of the sampler costs in this process: it holds
        # the interpreter lock while it walks every thread's stack
        from brpc_tpu_torch.builtin import sampler as sampler_mod
        t0 = time.perf_counter()
        walked = [len(sampler_mod.sample_once()) for _ in range(20)]
        sample_pass_ms = (time.perf_counter() - t0) / 20 * 1e3
        # -- every route answers 200, or 501 where its module is missing
        routes = {}
        for path in sorted(build_routes(server)):
            r = web.get(path)
            routes[path] = r.status
            check(r.status == (501 if path in NOT_PORTED_ROUTES else 200)
                  and r.body, f"route {path}: {r.status} {r.body[:200]!r}")
        check(engine.join_idle(30), f"{label}: the engine did not go idle")
        live = store.stats()["live_seqs"]
        check(live == 0, f"{label}: {live} sequences still live")
    finally:
        web.close()
        server.stop()
        server.join()
        engine.close()
        batcher.close()
        store.clear()
    check(store.pagepool.blocks_leased() == 0 and
          store.pagepool.pool.stats()["classes"] == free0,
          f"{label}: the page pool did not return to its baseline")
    check(not HotspotSampler.instance().running,
          f"{label}: the sampler outlived the last server")
    check(counts.paged > 0 and counts.flash > 0,
          f"{label}: launches {counts.as_dict()}")
    ms = 1e3

    def med(rows, k):
        return pct([r[k] for r in rows], 50)

    return {
        "config": label, "card": card, "requests": N_REQUESTS,
        "new_tokens": NEW_TOKENS,
        "cold_tokens_per_s": toks / t_cold, "warm_tokens_per_s": toks / t_warm,
        "python_hot_path_tokens_per_s": toks / t_python,
        "ttft_ms": {"cold": {"p50": ms * pct(ttft_c, 50),
                             "p99": ms * pct(ttft_c, 99)},
                    "warm": {"p50": ms * pct(ttft_w, 50),
                             "p99": ms * pct(ttft_w, 99)}},
        "gap_ms": {"cold_p50": ms * pct(gaps_c, 50),
                   "warm_p50": ms * pct(gaps_w, 50),
                   "warm_p99": ms * pct(gaps_w, 99)},
        "pairs": pairs,
        "pair_medians": {k: {"tokens_per_s": med(v, 0),
                             "ttft_ms_p50": ms * med(v, 1),
                             "ttft_ms_p99": ms * med(v, 2)}
                         for k, v in pairs.items()},
        "http_over_trpc": [h[0] / t[0] for h, t in zip(pairs["http"],
                                                       pairs["trpc"])],
        "step6_trpc": {"warm_tokens_per_s": rpc_rec["warm_tokens_per_s"],
                       "ttft_ms": rpc_rec["ttft_ms"]["warm"]},
        "score": score,
        "score_medians": {k: {"rows_per_s": med(v, 0),
                              "latency_ms_p50": ms * med(v, 1),
                              "latency_ms_p99": ms * med(v, 2)}
                          for k, v in score.items()},
        "step7_scoret": {"rows_per_s": control_rec["score"]["rows_per_s"],
                         "latency_ms": control_rec["score"]["latency_ms"]},
        "console_scrapes": len(scrapes),
        "console_scrape_ms": {"p50": ms * pct(scrapes, 50),
                              "p99": ms * pct(scrapes, 99)},
        "sampler_tokens_per_s": sampler,
        "sampler_medians": {k: pct(v, 50) for k, v in sampler.items()},
        "sampler_on_over_off": [b / a for a, b in zip(sampler["off"],
                                                      sampler["on"])],
        "sampler_pass_ms": sample_pass_ms,
        "sampler_threads_walked": max(walked),
        "routes": routes,
        "wall_s": time.perf_counter() - t_phase,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- step 16: request dumps and replay, the span database, the flight
# recorder --------------------------------------------------------------

CAPTURE_PAIRS = 5    # warm pass pairs, capture off and on
CAPTURE_DIR = os.path.join(ROOT, "build", "capture")


def serve_capture(dev, cfg, ctx, card):
    """Step 16 (see the module docstring): (b) behind one Server with
    ``rpc_dump`` (ratio 1), rpcz with its span database and the flight
    recorder on; the dump replayed against a second Server with the
    same weights; step 4's weights, prompts and dense oracle."""
    import shutil
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.rpcz as rpcz
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch import flags
    from brpc_tpu_torch.butil import flight
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.ici.block_pool import BlockPool
    from brpc_tpu_torch.rpc import meta as M
    from brpc_tpu_torch.rpc.rpc_dump import RpcDumper
    from brpc_tpu_torch.rpc.serialization import get_serializer
    from brpc_tpu_torch.tools import rpc_replay
    geo, prompts, oracle = ctx["geometry"], ctx["prompts"], ctx["oracle"]
    params = ctx["params"]
    toks = N_REQUESTS * NEW_TOKENS
    counts = Counts()
    t_phase = time.perf_counter()
    label = "b capture"
    # the checks' references, outside every counting window
    want = [unbatched_ids(params, cfg, dev, p) for p in prompts]
    shutil.rmtree(CAPTURE_DIR, ignore_errors=True)
    dump_dir = os.path.join(CAPTURE_DIR, "dump")
    span_dir = os.path.join(CAPTURE_DIR, "spans")

    def capture(on, dump_to=dump_dir):
        """rpc_dump, rpcz with its span database and the flight recorder,
        all on or all off."""
        flags.set_flag("rpc_dump_dir", dump_to, force=True)
        flags.set_flag("rpc_dump_ratio", 1, force=True)
        flags.set_flag("rpc_dump", on, force=True)
        rpcz.set_enabled(on)
        rpcz.set_database_dir(span_dir if on else None)
        flight.set_enabled(on)
        if not on:
            RpcDumper.instance().close()

    def streams_equal(name, streams):
        for i, (c, o) in enumerate(zip(streams, oracle)):
            check(c == o, f"{label} {name}: stream {i} streamed {c}, "
                          f"dense oracle {o}")

    class Replica:
        def __init__(self, name):
            # a block pool each: the two replicas live side by side
            self.store = models.make_store_for(
                cfg, page_tokens=geo["page_tokens"],
                max_blocks=geo["max_blocks"], device=dev,
                pool=BlockPool(dev), name=f"{name}_kv")
            self.free0 = self.store.pagepool.pool.stats()["classes"]
            self.engine = serving.DecodeEngine(
                runner=models.TransformerRunner(params, cfg, store=self.store,
                                                device=dev, name=name),
                store=self.store, num_slots=geo["num_slots"],
                max_pages_per_slot=geo["max_pages"],
                prefill_buckets=geo["buckets"], device=dev, name=name)
            self.batcher = serving.DynamicBatcher(
                models.TransformerRunner(params, cfg, device=dev,
                                         name=f"{name} score"),
                max_batch_size=8, max_delay_us=5000,
                length_buckets=(64, 256), dtype=np.int32,
                name=f"{name}_score")
            self.server = rpc.Server()
            serving.register_serving(self.server, batcher=self.batcher,
                                     engine=self.engine)
            self.server.start("127.0.0.1", 0)
            self.port = self.server.port

        def close(self):
            self.server.stop()
            self.server.join()
            self.engine.close()
            self.batcher.close()
            self.store.clear()
            check(self.store.pagepool.blocks_leased() == 0 and
                  self.store.pagepool.pool.stats()["classes"] == self.free0,
                  f"{label}: a page pool did not return to its baseline")

    def warm_pass(name):
        streams, _, _, _, wall = counts.window(lambda: rpc_generate_all(
            src.port, prompts, f"{label} {name}"))
        streams_equal(name, streams)
        return wall

    src = Replica("b_capture")
    dst = None
    web = rpc.HttpChannel(f"127.0.0.1:{src.port}", timeout_ms=60_000)
    try:
        # -- the captured pass: 8 traced Generate streams, one ScoreT
        # batch of 8 rows (B8 S256)
        capture(True)
        roots = []
        streams, hits, _, _, _ = counts.window(lambda: rpc_generate_all(
            src.port, prompts, f"{label} captured", roots=roots))
        streams_equal("captured", streams)
        scored, _, _ = counts.window(lambda: score_calls(
            src.port, prompts, N_REQUESTS, 0, f"{label} scoret"))
        hold_rows(f"{label} scoret", scored, want)
        check(counts.paged > 0 and counts.flash > 0,
              f"{label}: launches {counts.as_dict()}")
        check(src.engine.join_idle(60), f"{label}: the engine did not go "
                                        f"idle")
        flags.set_flag("rpc_dump", False, force=True)
        RpcDumper.instance().close()
        # -- 1. the dump: one record a request, each meta the call made
        records = rpc_replay.load_records(dump_dir)
        called = sorted([("Serving", "Generate")] * N_REQUESTS
                        + [("Serving", "ScoreT")] * N_REQUESTS)
        metas = [M.RpcMeta.decode(m) for m, _ in records]
        check(sorted((m.service, m.method) for m in metas) == called,
              f"{label}: the dump holds "
              f"{sorted((m.service, m.method) for m in metas)}")
        # -- 3. the span database: each Generate's tree, the in-memory
        # ring cleared, read back from disk and through /rpcz
        def tree(spans):
            return sorted((s.kind, s.service, s.method, s.parent_span_id)
                          for s in spans)

        def ring(root):
            return rpcz.recent_spans(2048, trace_id=root.trace_id)

        # (rpc_generate_all submitted the client roots): one span of
        # each kind a trace
        kinds = sorted(("client", "server", "decode", "prefill"))
        deadline = time.monotonic() + 10
        while not all(set(kinds) <= {s.kind for s in ring(r)}
                      for r in roots) and time.monotonic() < deadline:
            time.sleep(0.05)
        before = {r.trace_id: ring(r) for r in roots}
        for r in roots:
            got = sorted(s.kind for s in before[r.trace_id])
            check(got == kinds, f"{label}: trace {r.trace_id} holds the "
                                f"spans {got}, one each of {kinds} wanted")
        pages = {tid: rpcz.format_trace(sp) for tid, sp in before.items()}
        with rpcz._collect_lock:
            rpcz._collected.clear()
        span_trees = []
        for tid, spans in before.items():
            check(not rpcz.recent_spans(2048, trace_id=tid),
                  f"{label}: the ring still holds trace {tid}")
            disk = rpcz.load_disk_spans(2048, trace_id=tid)
            check(tree(disk) == tree(spans),
                  f"{label}: trace {tid} from disk {tree(disk)} against "
                  f"{tree(spans)}")
            page = web.get(f"/rpcz?trace_id={tid}")
            check(page.status == 200 and page.body.decode() == pages[tid],
                  f"{label}: /rpcz?trace_id={tid}: {page.status} "
                  f"{page.body[:300]!r}")
            span_trees.append(len(disk))
        # -- 4. the flight recorder, read twice during a warm pass
        reads = []

        def read_flight():
            r = web.get("/flightrecorder?fmt=json&limit=64")
            check(r.status == 200, f"/flightrecorder: HTTP {r.status}")
            reads.append(json.loads(r.body))

        th = threading.Thread(target=lambda: warm_pass("flight"))
        th.start()
        read_flight()
        time.sleep(0.2)
        read_flight()
        th.join(300)
        check(not th.is_alive(), f"{label}: the flight pass hung")

        def native(snap, prefix):
            return {t["thread"]: t["events"] for t in snap["threads"]
                    if t["thread"].startswith(prefix) and t["live"]}

        live = {}
        for prefix in ("worker/", "epoll/"):
            a, b = native(reads[0], prefix), native(reads[1], prefix)
            check(a and b, f"{label}: /flightrecorder names no {prefix} "
                           f"thread: {sorted(t['thread'] for t in reads[1]['threads'])}")
            moved = [n for n in b if b[n] > a.get(n, b[n])]
            check(moved, f"{label}: no {prefix} thread's events advanced "
                         f"between two reads: {a} then {b}")
            live[prefix] = {"threads": len(b), "advanced": len(moved)}
        sc = reads[1]["syscalls"]
        check(sc["read_syscalls"] > 0 and sc["write_syscalls"] > 0,
              f"{label}: syscall counters {sc}")
        check(reads[1]["enabled"] and reads[1]["stats"]["events"] > 0,
              f"{label}: flight stats {reads[1]['stats']}")
        last_events = sorted({t["last"] for t in reads[1]["threads"]
                              if t["thread"].startswith(("worker/",
                                                         "epoll/"))})
        # -- 2. the replay, against a second server with the same weights
        rpcz.set_enabled(False)
        dst = Replica("b_replay")
        out = io.StringIO()

        def replay_all():
            # the replayed Generates decode on after their answers: the
            # window closes when the target's engine is idle again
            got = rpc_replay.run_replay(f"127.0.0.1:{dst.port}", dump_dir,
                                        timeout_ms=120_000, out=out)
            check(dst.engine.join_idle(120), f"{label}: the replay "
                                             f"target's engine hung")
            return got

        summary = counts.window(replay_all)
        check(summary["replayed"] == len(records) and
              summary["errors"] == 0, f"{label}: run_replay {summary}")
        # every replayed Generate decoded its 32 tokens to nobody
        st = dst.engine.stats()
        check(st["tokens"] == toks and st["emit_cut"] == 0,
              f"{label}: the replayed Generates streamed {st['tokens']} "
              f"tokens, {st['emit_cut']} cut")
        ep = str2endpoint(f"127.0.0.1:{dst.port}")

        def replay_one(meta_bytes, body):
            c = rpc_replay.replay_one(ep, meta_bytes, body,
                                      timeout_ms=120_000)
            c.join()
            check(dst.engine.join_idle(120), f"{label}: the replay "
                                             f"target's engine hung")
            return c

        score_diff, generate_answers = 0.0, []
        rows = {tuple(p): i for i, p in enumerate(prompts)}
        originals = {i: np.asarray(y, np.float32) for i, y in scored}
        for (meta_bytes, body), meta in zip(records, metas):
            c = counts.window(lambda: replay_one(meta_bytes, body))
            check(c.error_code == 0, f"{label}: replayed "
                                     f"{meta.service}.{meta.method}: "
                                     f"{c.error_code} {c.error_text}")
            if meta.method == "ScoreT":
                req = get_serializer(meta.content_type).decode(
                    body, meta.tensor_header)
                i = rows[tuple(int(t) for t in np.asarray(req["x"]))]
                y = np.asarray(c.response["y"], np.float32)
                check(y.shape == originals[i].shape,
                      f"{label}: replayed row {i} shape {y.shape}")
                score_diff = max(score_diff,
                                 float(np.abs(y - originals[i]).max()))
                hold_rows(f"{label} replayed scoret", [(i, y)], want)
            else:
                # no client stream answers to the captured stream id:
                # the call is accepted, its frames find no reader
                generate_answers.append(c.response)
                check(c.response.get("accepted") is True,
                      f"{label}: replayed Generate answered {c.response}")
        # -- 5. the cost: warm passes, everything off and on, the order
        # alternating from pair to pair (a pair's second pass runs on a
        # warmer host)
        cost_dump = os.path.join(CAPTURE_DIR, "cost_dump")
        cost = {"off": [], "on": []}
        for i in range(CAPTURE_PAIRS):
            for kind in ("off", "on") if i % 2 == 0 else ("on", "off"):
                capture(kind == "on", dump_to=cost_dump)
                cost[kind].append(toks / warm_pass(f"cost {kind} {i}"))
        capture(False)
        flight.set_enabled(True)
        check(src.engine.join_idle(60), f"{label}: the engine did not go "
                                        f"idle")
        for r in (src, dst):
            live_seqs = r.store.stats()["live_seqs"]
            check(live_seqs == 0, f"{label}: {live_seqs} sequences live")
    finally:
        capture(False)
        flight.set_enabled(True)
        web.close()
        src.close()
        if dst is not None:
            dst.close()
    check(counts.paged > 0 and counts.flash > 0,
          f"{label}: launches {counts.as_dict()}")
    return {
        "config": label, "card": card, "requests": N_REQUESTS,
        "new_tokens": NEW_TOKENS, "dump_records": len(records),
        "dumped_calls": {f"{s}.{m}": called.count((s, m))
                         for s, m in sorted(set(called))},
        "replay": summary, "replayed_score_max_abs_diff": score_diff,
        "replayed_generates": len(generate_answers),
        "replayed_generate_answers": generate_answers,
        "span_trees_from_disk": span_trees,
        "flight_threads": live, "flight_last_events": last_events,
        "syscalls": sc,
        "cost_tokens_per_s": cost,
        "cost_on_over_off": [b / a for a, b in zip(cost["off"],
                                                   cost["on"])],
        "wall_s": time.perf_counter() - t_phase,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- step 17: the cluster front door --------------------------------------

ROUTER_PAIRS = 2      # alternating warm router/direct pairs
KILL_AFTER = 8        # tokens a stream holds when its replica or router dies
RESTART_STREAMS = 4   # sessions through the router process that is killed


def until(pred, timeout_s, poll_s=0.005):
    """Poll ``pred`` until it holds or ``timeout_s`` passes."""
    deadline = time.monotonic() + timeout_s
    while True:
        if pred():
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(poll_s)


def router_generate_all(addr, prompts, label):
    """One ``RouterClient`` session per prompt, all started at once.
    Returns the streams, the client-timed time to first token (seconds),
    the session ids and the wall time."""
    import brpc_tpu_torch.serving as serving
    cli = serving.RouterClient(addr, timeout_ms=120_000)
    t0 = time.perf_counter()
    started = []
    for p in prompts:
        first = []

        def emit(tok, first=first):
            if not first:
                first.append(time.perf_counter())

        t_issue = time.perf_counter()
        started.append((cli.start(p, NEW_TOKENS, emit=emit), first,
                        t_issue))
    for i, (g, _, _) in enumerate(started):
        check(g.wait(300), f"{label}: session {i} hung")
        check(g.error is None, f"{label}: session {i} ended with "
                               f"E{g.error}")
    wall = time.perf_counter() - t0
    ttft = [first[0] - t for _, first, t in started if first]
    return ([g.tokens for g, _, _ in started], ttft,
            [g.session_id for g, _, _ in started], wall)


def router_stats(addr):
    import brpc_tpu_torch.rpc as rpc
    return rpc.Channel(addr, timeout_ms=30_000).call_sync(
        "Router", "Stats", {}, serializer="json",
        response_serializer="json")


def serve_router(dev, cfg, ctx, card):
    """Step 17 (see the module docstring): two replicas of (b) behind the
    port's ``ClusterRouter``; step 4's weights, prompts and oracle."""
    import tempfile
    import brpc_tpu_torch.migrate as migrate
    import brpc_tpu_torch.models as models
    import brpc_tpu_torch.rpc as rpc
    import brpc_tpu_torch.serving as serving
    from brpc_tpu_torch import errors
    from brpc_tpu_torch.ici.block_pool import BlockPool
    from brpc_tpu_torch.rpc.stream import StreamRegistry
    from brpc_tpu_torch.serving.router import parse_retry_after_s
    from brpc_tpu_torch.serving.router_proc import spawn_router
    geo, prompts, oracle = ctx["geometry"], ctx["prompts"], ctx["oracle"]
    params = ctx["params"]
    pt = geo["page_tokens"]
    toks = N_REQUESTS * NEW_TOKENS
    label = "b router"
    counts = Counts()
    t_phase = time.perf_counter()
    streams0 = StreamRegistry.instance().count()
    wal_dir = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    reps, procs = [], []

    def replica(name):
        """Store, runner, engine and a Server with Serving, _kvmig,
        _cluster and _telemetry, on a block pool of its own."""
        store = models.make_store_for(cfg, page_tokens=pt,
                                      max_blocks=geo["max_blocks"],
                                      pool=BlockPool(dev), name=name,
                                      commit_live_pages=True)
        engine = serving.DecodeEngine(
            runner=models.TransformerRunner(params, cfg, store=store,
                                            device=dev, name=name),
            store=store, num_slots=geo["num_slots"],
            max_pages_per_slot=geo["max_pages"],
            prefill_buckets=geo["buckets"], device=dev, name=name)
        server = rpc.Server(enable_dcn=True, dcn_device=str(dev))
        svc = serving.register_serving(server, engine=engine)
        mig = migrate.register_migration(server, store)
        ctrl = serving.register_cluster_control(server, engine=engine,
                                                store=store, name=name)
        serving.register_telemetry(server, name=name)
        server.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{server.port}"
        svc.prefix_fetcher = migrate.make_prefix_fetcher(mig.migrator, addr)
        r = {"name": name, "store": store, "engine": engine,
             "server": server, "ctrl": ctrl, "mig": mig.migrator,
             "addr": addr, "port": server.port, "alive": True,
             "free0": store.pagepool.pool.stats()["classes"]}
        reps.append(r)
        return r

    def kill(r):
        """Process-death analog: the socket goes, the engine stops."""
        r["alive"] = False
        r["server"].stop()
        r["server"].join()
        r["engine"].close()

    def streams_equal(name, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            check(g == w, f"{label} {name}: stream {i} streamed {g}, dense "
                          f"oracle {w}")

    def pushes():
        """Buddy pushes (PushTo migrations) and their pages, all
        replicas."""
        n = pages = 0
        for r in reps:
            for route in r["mig"].routes.values():
                n += route["migrations"]
                pages += route["pages"]
        return n, pages

    router = rsrv = None
    try:
        a, b = replica("b_router_r0"), replica("b_router_r1")
        table = serving.SessionTable(wal=os.path.join(wal_dir, "r1.wal"))
        router = serving.ClusterRouter(
            [a["addr"], b["addr"]], sessions=table,
            replicate_sessions=True, page_tokens=pt, name="b_router",
            check_interval_s=0.05, timeout_ms=120_000,
            progress_timeout_s=60.0)
        rsrv = rpc.Server()
        serving.register_router(rsrv, router)
        rsrv.start("127.0.0.1", 0)
        raddr = f"127.0.0.1:{rsrv.port}"
        # the kill and router-restart prompts' dense oracle, outside the
        # counted windows (Generate never reaches the dense forward)
        rng = np.random.default_rng(17)
        rprompts = [rng.integers(0, cfg.vocab, len(prompts[0])).tolist()
                    for _ in range(RESTART_STREAMS + 1)]
        roracle = [models.dense_generate(params, cfg, p, NEW_TOKENS,
                                         device=dev) for p in rprompts]
        # -- 1. routed streams, cold then warm; repeat prefixes stay put
        cold, ttft_cold, sids, wall_cold = counts.window(
            lambda: router_generate_all(raddr, prompts, f"{label} cold"))
        streams_equal("cold", cold, oracle)
        placed = [table.get(s).replica for s in sids]
        warm, ttft_warm, sids, wall_warm = counts.window(
            lambda: router_generate_all(raddr, prompts, f"{label} warm"))
        streams_equal("warm", warm, oracle)
        check([table.get(s).replica for s in sids] == placed,
              f"{label}: a repeated prefix moved replica ({placed})")
        placement = {r["addr"]: placed.count(r["addr"]) for r in (a, b)}
        # -- 2. warm pairs: through the router against straight to one
        # replica (the same prompts; warmed on it first)
        counts.window(lambda: rpc_generate_all(a["port"], prompts,
                                               f"{label} direct warm-up"))
        pair = {"router": [], "direct": []}
        pair_ttft = {"router": [], "direct": []}
        for i in range(ROUTER_PAIRS):
            for kind in ("router", "direct") if i % 2 == 0 \
                    else ("direct", "router"):
                if kind == "router":
                    got, ttft, _, wall = counts.window(
                        lambda: router_generate_all(raddr, prompts,
                                                    f"{label} pair {i}"))
                else:
                    got, _, ttft, _, wall = counts.window(
                        lambda: rpc_generate_all(
                            a["port"], prompts, f"{label} direct {i}"))
                streams_equal(f"{kind} pair {i}", got, oracle)
                pair[kind].append(toks / wall)
                pair_ttft[kind].append(1e3 * pct(ttft, 50))
        # one more warm router pass with the fleet-telemetry pulls off:
        # what they cost the pass (printed, not gated)
        router.telemetry_collect = False
        got, _, _, wall = counts.window(
            lambda: router_generate_all(raddr, prompts,
                                        f"{label} pulls off"))
        streams_equal("pulls off", got, oracle)
        pulls_off_tokens_per_s = toks / wall
        router.telemetry_collect = True
        # the default ladder held level 0 over the warm replicas
        check(not any(router.stats()["gradient_fired"].values()),
              f"{label}: the gradient fired over warm replicas: "
              f"{router.stats()['ladder']}")
        # -- 3. shed: the gradient forced to level 3; the replicas'
        # floors follow over _cluster, a new session is refused
        forced = [3]
        router.add_floor_source(lambda: forced[0])
        check(until(lambda: all(r["ctrl"].level == 3 for r in (a, b)), 10),
              f"{label}: the replicas' floors did not follow over "
              f"_cluster: {[r['ctrl'].level for r in (a, b)]}")
        check(all(r["engine"].degraded_clamp == router.clamp_new_tokens
                  for r in (a, b)), f"{label}: level 3 did not clamp")
        shed = None
        try:
            g = serving.RouterClient(raddr, shed_retries=0).start(
                prompts[0], NEW_TOKENS)
            g.drop()
        except errors.RpcError as e:
            shed = e
        check(shed is not None and shed.code == errors.ELIMIT,
              f"{label}: a session was admitted at level 3 ({shed})")
        retry_after = parse_retry_after_s(shed.text)
        check(retry_after is not None and retry_after > 0,
              f"{label}: the shed carried no retry_after_s: {shed.text}")
        shed_fired = router.stats()["gradient_fired"]
        forced[0] = 0
        check(until(lambda: router.level == 0 and all(
            r["ctrl"].level == 0 and r["engine"].degraded_clamp is None
            for r in (a, b)), 10), f"{label}: the gradient did not clear")
        # -- 4. a replica killed mid-decode while its client drops; the
        # session resumes on the other from the client's cursor
        cli = serving.RouterClient(raddr, timeout_ms=120_000)

        def kill_and_resume():
            g = cli.start(rprompts[0], NEW_TOKENS)
            check(g.wait_tokens(KILL_AFTER, 120), f"{label}: no tokens")
            s = table.get(g.session_id)
            check(until(lambda: s.replicated_pages > 0, 60),
                  f"{label}: no page reached the ring buddy")
            victim = next(r for r in (a, b)
                          if s.replica in (r["addr"],
                                           f"127.0.0.1:{r['port']}"))
            cursor, seen = g.cursor, g.tokens
            g.drop()
            record0 = s.cursor
            t_kill = time.perf_counter()
            kill(victim)
            check(until(lambda: s.cursor > record0 or s.state != "running",
                        120, 0.0005),
                  f"{label}: the session never resumed")
            stall = time.perf_counter() - t_kill
            out = cli.resume_wait(g.session_id, cursor, timeout_s=120)
            check(out["error"] is None and s.state == "finished",
                  f"{label}: resume ended with E{out['error']} "
                  f"({s.state})")
            streams_equal("replica kill", [seen[:cursor] + out["tokens"]],
                          [roracle[0]])
            total = len(rprompts[0]) + NEW_TOKENS
            check(s.resumes >= 1 and 0 < s.re_decoded_tokens < total,
                  f"{label}: resumes {s.resumes}, re-decoded "
                  f"{s.re_decoded_tokens} of {total}")
            return victim, stall, s.snapshot()

        victim, kill_stall, killed = counts.window(kill_and_resume)
        survivor = b if victim is a else a
        router_pushes = pushes()
        router_placements = router.placements()
        router.close()
        table.close()
        rsrv.stop()
        rsrv.join()
        rsrv = None
        # -- 5. the router in its own process, SIGKILLed mid-generation;
        # a successor over the same WAL adopts the sessions and every
        # client resumes from its cursor.  A fresh replica replaces the
        # killed one; the survivor keeps its warm cache
        c = replica("b_router_r2")
        check(survivor["engine"].join_idle(60),
              f"{label}: {survivor['name']} not idle")
        wal2 = os.path.join(wal_dir, "proc.wal")
        addrs = [survivor["addr"], c["addr"]]
        rkw = dict(replicate_sessions=True, page_tokens=pt,
                   timeout_ms=120_000, progress_timeout_s=60.0,
                   timeout_s=120.0)

        def router_death():
            proc, paddr = spawn_router(wal2, addrs, **rkw)
            procs.append(proc)
            epoch1 = router_stats(paddr)["epoch"]
            pcli = serving.RouterClient(paddr, timeout_ms=120_000)
            gens = [pcli.start(p, NEW_TOKENS) for p in rprompts[1:]]
            for i, g in enumerate(gens):
                check(g.wait_tokens(KILL_AFTER, 120),
                      f"{label}: router stream {i} has no tokens")
            t_kill = time.perf_counter()
            proc.kill()
            proc.wait(30)
            held = [(g.session_id, g.cursor, g.tokens) for g in gens]
            for g in gens:
                g.drop()
            proc2, paddr2 = spawn_router(wal2, addrs, **rkw)
            procs.append(proc2)
            t_up = time.perf_counter()
            st2 = router_stats(paddr2)
            check(st2["epoch"] > epoch1,
                  f"{label}: successor epoch {st2['epoch']} <= {epoch1}")
            check((st2["wal_replay"] or {}).get("live", 0) >= len(gens),
                  f"{label}: the successor adopted {st2['wal_replay']}")
            qcli = serving.RouterClient(paddr2, timeout_ms=120_000)
            firsts, resumed = [], []
            for sid, cursor, seen in held:
                first = []

                def emit(tok, first=first):
                    if not first:
                        first.append(time.perf_counter())

                resumed.append((qcli.resume(sid, cursor, emit=emit), first,
                                cursor, seen))
            for i, (g, first, cursor, seen) in enumerate(resumed):
                check(g.wait(120) and g.error is None,
                      f"{label}: resumed stream {i} ended with E{g.error}")
                streams_equal(f"router restart {i}",
                              [seen[:cursor] + g.tokens], [roracle[i + 1]])
                firsts.append(first[0] if first else None)
            stats = router_stats(paddr2)
            proc2.stdin.close()
            proc2.wait(30)
            return {"epochs": [epoch1, st2["epoch"]],
                    "kill_to_successor_up_ms": 1e3 * (t_up - t_kill),
                    "kill_to_first_resumed_token_ms": sorted(
                        1e3 * (f - t_kill) for f in firsts if f),
                    "wal_replay": st2["wal_replay"],
                    "resumes": stats["resumes"],
                    "replayed_tokens": stats["replayed_tokens"],
                    "cursors": [h[1] for h in held]}

        restart = counts.window(router_death)
        all_pushes = pushes()
        # -- 6. pages, rings and streams back at their baselines
        for r in reps:
            if r["alive"]:
                check(r["engine"].join_idle(60), f"{label}: {r['name']} "
                                                 f"not idle")
                kill(r)
            live_n = r["store"].stats()["live_seqs"]
            check(live_n == 0, f"{label}: {live_n} sequences live on "
                               f"{r['name']}")
            r["store"].clear()
            check(r["store"].pagepool.blocks_leased() == 0 and
                  r["store"].pagepool.pool.stats()["classes"] == r["free0"],
                  f"{label}: {r['name']}'s page pool is not at its "
                  f"baseline")
        check(until(lambda: StreamRegistry.instance().count() <= streams0,
                    10, 0.05),
              f"{label}: {StreamRegistry.instance().count() - streams0} "
              f"streams leaked")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        if router is not None:
            router.close()
        if rsrv is not None:
            rsrv.stop()
            rsrv.join()
        for r in reps:
            if r["alive"]:
                kill(r)
        import shutil
        shutil.rmtree(wal_dir, ignore_errors=True)
    check(counts.paged > 0, f"{label}: launches {counts.as_dict()}")
    return {
        "config": label, "card": card, "requests": N_REQUESTS,
        "new_tokens": NEW_TOKENS,
        "cold_tokens_per_s": toks / wall_cold,
        "warm_tokens_per_s": toks / wall_warm,
        "ttft_ms": {"cold": 1e3 * pct(ttft_cold, 50),
                    "warm": 1e3 * pct(ttft_warm, 50)},
        "placement": placement,
        "pair_tokens_per_s": pair, "pair_ttft_ms_p50": pair_ttft,
        "pair_tokens_per_s_median": {k: pct(v, 50)
                                     for k, v in pair.items()},
        "router_over_direct": [r / d for r, d in zip(pair["router"],
                                                     pair["direct"])],
        "pulls_off_tokens_per_s": pulls_off_tokens_per_s,
        "shed": {"code": shed.code, "retry_after_s": retry_after,
                 "gradient_fired": shed_fired},
        "replica_kill": {"stall_ms": 1e3 * kill_stall, "session": killed},
        "router_restart": restart,
        "buddy_pushes": {"in_process_router": router_pushes,
                         "whole_step": all_pushes},
        "placements": router_placements[-4:],
        "wall_s": time.perf_counter() - t_phase,
        "launches": counts.as_dict(), "paged_cuda_launches": counts.paged_cuda,
    }


# ---- PS and training phases: the flagship train step, the shard fleet,
# the trainer through the wire -------------------------------------------

# the flagship PS model at the width of the repo's own TPU run
# (``session4_flagship_train_step`` in BENCH_DEVICE_SESSION_r05.json)
FLAGSHIP = dict(vocab=32768, d_model=1024, d_ff=4096, n_layers=8,
                seq=1024, batch=8)
TRAIN_STEPS = 10
TRAIN_LR = 0.1
# step 1 at bf16 against the same step at f32: the loss within 1e-3 of
# its value, the gradients (all parameters as one vector) within 5e-2 of
# their norm (bf16 keeps 8 bits; a mid-width CPU run of the same
# comparison measured 1e-5 and 8e-3)
STEP_TOL = {"loss_rel": 1e-3, "grad_rel": 5e-2}
PS_SHARDS = 4
PS_BUCKETS = (8, 32, 128, 512, 4096)
PS_TIMED = 10        # timed lookups and waves of the fleet phase
# the trainer phase: bench.py's training rung (vocab 65536, d 32, 2
# shards, 4 workers, Adam lr 0.01, 2048-key waves) for the wave pairs;
# the two trainer runs at TRAINER_VOCAB, because their dense Pull/Push
# ride JSON: w_out is d x vocab floats each way every worker step, and
# one JSON Pull of it at vocab 65536 takes ~0.8 s on an H100 machine's
# host (~1 minute a run)
TRAINER_VOCAB = 1024
WAVE_VOCAB = 65536
WAVE_KEYS = 2048
WAVE_PAIRS = 3
WAVE_WINDOW_S = 2.0


def flagship_flops(cfg):
    """Operations of one train step: the forward's products (per layer
    x@wqk, q@x^T, scores@x, x@wup, h@wdown; then x@w_out) times 3 with
    the backward."""
    t = cfg.batch * cfg.seq
    d, f, s, v = cfg.d_model, cfg.d_ff, cfg.seq, cfg.vocab
    layer = 2 * t * d * d + 2 * 2 * t * s * d + 2 * 2 * t * d * f
    return 3 * (cfg.n_layers * layer + 2 * t * d * v)


def flagship_embed():
    """The flagship's ``embed`` as step 11 draws it (seed 21), on the
    host: ``init_params`` draws ``embed`` first from its generator."""
    import torch
    gen = torch.Generator().manual_seed(21)
    return (torch.randn((FLAGSHIP["vocab"], FLAGSHIP["d_model"]),
                        generator=gen) * 0.02).numpy()


def train_flagship(dev, card):
    """Step 11 (see the module docstring): the flagship PS model's train
    step at full width."""
    import torch

    import brpc_tpu_torch.models.parameter_server as psm
    cfg = psm.PSConfig(**FLAGSHIP)
    torch.cuda.reset_peak_memory_stats()
    params = psm.init_params(cfg, seed=21, device=dev)
    tokens, targets = psm.make_example_batch(cfg, seed=22, device=dev)
    # step 1 at bf16 and at f32 (TF32 off)
    l16, g16 = psm.loss_and_grads(params, tokens, targets, torch.bfloat16)
    l32, g32 = psm.loss_and_grads(params, tokens, targets, torch.float32)
    num = sum(float(((g16[k] - g32[k]) ** 2).sum()) for k in g32)
    den = sum(float((g32[k] ** 2).sum()) for k in g32)
    loss_rel = abs(float(l16) - float(l32)) / abs(float(l32))
    grad_rel = (num / den) ** 0.5
    per_param = {k: float((g16[k] - g32[k]).norm() / g32[k].norm())
                 for k in g32}
    del g16, g32
    check(loss_rel <= STEP_TOL["loss_rel"],
          f"flagship step 1: bf16 loss {float(l16)} vs f32 {float(l32)}")
    check(grad_rel <= STEP_TOL["grad_rel"],
          f"flagship step 1: bf16 grads off f32 by {grad_rel:.3g}")
    losses, step_ms = [], []
    p = params
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, loss = psm.train_step(p, tokens, targets, lr=TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"flagship losses {losses}")
    check(losses[-1] < losses[0],
          f"flagship: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    _, prof = profile_window(
        lambda: psm.train_step(p, tokens, targets, lr=TRAIN_LR))
    launches, _ = launches_per_call(
        lambda: psm.train_step(p, tokens, targets, lr=TRAIN_LR))
    warm_ms = float(np.median(step_ms[1:]))
    flops = flagship_flops(cfg)
    return {
        "config": dict(FLAGSHIP), "card": card, "lr": TRAIN_LR,
        "loss_step1_bf16": float(l16), "loss_step1_f32": float(l32),
        "loss_rel_diff": loss_rel, "grad_rel_diff": grad_rel,
        "grad_rel_diff_per_param": per_param, "tolerance": STEP_TOL,
        "losses": losses, "step_ms": step_ms, "warm_step_ms": warm_ms,
        "tokens_per_s": cfg.batch * cfg.seq / (warm_ms / 1e3),
        "tflop_per_step": flops / 1e12,
        "achieved_tflops": flops / (warm_ms / 1e3) / 1e12,
        "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3,
        "bound_by": "operations", "bound_rate": RATE["bfloat16"],
        "share_of_bound": flops / PEAK_FLOPS["bfloat16"] * 1e3 / warm_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "cuda_launches_per_step": launches, "profile": prof}


def device_ms(fn, dev):
    """Device time of one call of ``fn`` with a cold L2: calls each
    after a 128 MiB ``bitwise_not_`` that evicts the 50 MB L2 (a shard's
    table would otherwise stay in it between calls, which traffic to
    four shards does not allow), replayed from a CUDA graph
    (:func:`measure`), less the flushes alone."""
    import torch
    flush = torch.zeros(128 << 20, dtype=torch.int8, device=dev)

    def flushed():
        flush.bitwise_not_()
        fn()

    both, _ = measure(flushed)
    alone, _ = measure(flush.bitwise_not_)
    return both - alone


def ps_device_rows(dev, embed):
    """The PS path's device programs at one shard's shapes: the row
    gather and scatter-add of one shard's share of an 8192-key wave
    (2048 keys) and ``fused_apply`` per kind at the 4096 bucket, each
    with its device ms (cold L2), eager ms (back to back, as issued
    from Python), CUDA launches per call and bytes bound (keys, grads
    and the gathered rows/slots read and written once)."""
    import torch

    import brpc_tpu_torch.train.optimizer as opt
    rows_n, d = embed.shape[0] // PS_SHARDS, embed.shape[1]
    rng = np.random.default_rng(31)
    table = torch.from_numpy(np.array(embed[:rows_n])).to(dev)
    out = []

    def row(name, fn, nbytes):
        dms = device_ms(fn, dev)
        n, names = launches_per_call(fn)
        eager = time_ms(fn)
        b = bound(nbytes, 0, "float32", dms)
        out.append({"program": name, "device_ms": dms, "eager_ms": eager,
                    "cuda_launches_per_call": n, "device_ops": names[:12],
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "share_of_bound": b["share_of_bound"]})

    k2048 = torch.from_numpy(rng.integers(0, rows_n, 2048)).to(dev)
    g2048 = torch.from_numpy(rng.integers(-3, 4, (2048, d)).astype(
        np.float32)).to(dev)
    row(f"gather t[k] [2048] -> [2048, {d}]", lambda: table[k2048],
        2048 * 8 + 2 * 2048 * d * 4)
    scratch = table.clone()
    row(f"scatter-add t.index_add_ [2048, {d}]",
        lambda: scratch.index_add_(0, k2048, g2048),
        2048 * 8 + 2048 * d * 4 + 2 * 2048 * d * 4)
    b = PS_BUCKETS[-1]
    keys = torch.from_numpy(rng.integers(0, rows_n, b)).to(dev)
    grads = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(
        np.float32)).to(dev)
    valid = torch.ones((b,), dtype=torch.float32, device=dev)
    for kind, n_state in (("sgdm", 2), ("adam", 3)):
        state = [table.clone()] + [torch.zeros_like(table)
                                   for _ in range(n_state - 1)]
        hp = (0.5, 0.5)
        if kind == "adam":
            state.append(torch.zeros((rows_n,), dtype=torch.float32,
                                     device=dev))
            hp = (0.5, 0.5, 0.75, 1.0)
        fn = opt.fused_apply(kind)
        nbytes = b * 8 + b * 4 + b * d * 4 + 2 * n_state * b * d * 4 + \
            (2 * b * 4 if kind == "adam" else 0)
        row(f"fused_apply {kind} bucket {b} x {d}",
            lambda fn=fn, st=state, hp=hp: fn(*st, keys, grads, valid, *hp),
            nbytes)
    return out


def ps_fleet(dev, card, embed):
    """Step 12 (see the module docstring): the flagship table on four
    shard servers, bit-equal to the dense oracle."""
    import torch

    from brpc_tpu_torch.psserve.client import _next_uid_seq
    from brpc_tpu_torch.train.optimizer import OptimizerSpec, oracle_apply
    vocab, d = embed.shape
    # integer-valued (the flagship's draws x 100, rounded): every float
    # addition of integer grads is exact, so the atomic order of the
    # card's scatter-add cannot change a bit
    table = np.round(embed * 100).astype(np.float32)
    shards, cli, close = ps_servers(dev, PS_SHARDS, vocab, d, PS_BUCKETS,
                                    "smoke_ps", table)
    rng = np.random.default_rng(41)

    def wave():
        return (rng.integers(0, vocab, FLAGSHIP["batch"] * FLAGSHIP["seq"]),
                rng.integers(-3, 4, (FLAGSHIP["batch"] * FLAGSHIP["seq"], d)
                             ).astype(np.float32))

    def fleet_rows():
        return np.concatenate([sh.snapshot_rows() for sh in shards])

    def fleet_slots(spec):
        snaps = [sh.snapshot_slots() for sh in shards]
        return {k: np.concatenate([s[k] for s in snaps])
                for k in spec.slot_names()}

    try:
        keys, _ = wave()
        check(np.array_equal(cli.lookup(keys), table[keys]),
              "ps fleet: lookup differs from the dense table")
        keys, grads = wave()
        cli.update(keys, grads)
        want = torch.from_numpy(table).to(dev).index_add_(
            0, torch.from_numpy(keys).to(dev),
            torch.from_numpy(grads).to(dev)).cpu().numpy()
        check(np.array_equal(fleet_rows(), want),
              "ps fleet: plain update differs from the dense scatter-add")
        slots = {"m": np.zeros_like(table)}
        sgdm = OptimizerSpec("sgdm", lr=0.5, momentum=0.5)
        adam = OptimizerSpec("adam", lr=0.5, beta1=0.5, beta2=0.75,
                             eps=1.0)
        acks = None
        for spec in (sgdm, adam):
            keys, grads = wave()
            tok = _next_uid_seq()
            acks = cli.update(keys, grads, update_token=tok,
                              optimizer=spec)
            if spec.kind == "adam":
                slots.setdefault("v", np.zeros_like(table))
                slots.setdefault("t", np.zeros((vocab,), np.float32))
            want, slots = oracle_apply(want, slots, keys, grads, spec,
                                       device=dev)
            check(np.array_equal(fleet_rows(), want),
                  f"ps fleet: {spec.kind} rows differ from oracle_apply")
            got = fleet_slots(spec)
            for k in spec.slot_names():
                check(np.array_equal(got[k], slots[k]),
                      f"ps fleet: {spec.kind} slot {k} differs from "
                      f"oracle_apply")
        # the adam wave again under its token: acked with the original
        # versions, nothing applied
        vers = [sh.version for sh in shards]
        again = cli.update(keys, grads, update_token=tok, optimizer=adam)
        check(again == acks and [sh.version for sh in shards] == vers,
              f"ps fleet: replayed token acked {again}, first {acks}")
        check(np.array_equal(fleet_rows(), want),
              "ps fleet: a replayed token changed the rows")
        # timed: lookups and adam waves of 8192 keys, client-timed
        look_ms, wave_ms = [], []
        for _ in range(PS_TIMED):
            keys, grads = wave()
            t0 = time.perf_counter()
            cli.lookup(keys)
            look_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            cli.update(keys, grads, optimizer=adam)
            wave_ms.append((time.perf_counter() - t0) * 1e3)
        check(cli.n_stale_reads == 0,
              f"ps fleet: {cli.n_stale_reads} stale reads")
        stats = [sh.stats() for sh in shards]
    finally:
        close()
    programs = ps_device_rows(dev, table)
    keys_n = FLAGSHIP["batch"] * FLAGSHIP["seq"]
    return {
        "card": card, "table": [vocab, d], "shards": PS_SHARDS,
        "wave_keys": keys_n, "key_buckets": list(PS_BUCKETS),
        "lookup_ms": {"p50": pct(look_ms, 50), "p99": pct(look_ms, 99)},
        "wave_ms": {"p50": pct(wave_ms, 50), "p99": pct(wave_ms, 99)},
        "lookups_per_s": 1e3 / pct(look_ms, 50),
        "waves_per_s": 1e3 / pct(wave_ms, 50),
        "keys_per_s_lookup": keys_n * 1e3 / pct(look_ms, 50),
        "stale_reads": cli.n_stale_reads,
        "versions": [s["version"] for s in stats],
        "dup_updates": [s["dup_updates"] for s in stats],
        "programs": programs}


def ps_servers(dev, n, vocab, dim, buckets, prefix, table):
    """``n`` shard servers of a ``vocab`` x ``dim`` table on ``dev``, each
    behind its own port ``Server``, and a tensorframe ``PSClient`` over a
    ``PartitionChannel`` in front.  Returns (shards, client, close)."""
    import brpc_tpu_torch.rpc as rpc
    from brpc_tpu_torch import psserve
    servers, svcs, shards = [], [], []
    pc = rpc.PartitionChannel(n)
    for i in range(n):
        sh = psserve.EmbeddingShardServer(i, n, vocab, dim, table=table,
                                          key_buckets=buckets,
                                          name=f"{prefix}_ps", device=dev)
        s = rpc.Server()
        svcs.append(psserve.register_psserve(s, sh, name=f"{prefix}_{i}"))
        s.start("127.0.0.1", 0)
        servers.append(s)
        shards.append(sh)
        pc.add_partition(i, rpc.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=60_000))
    cli = psserve.PSClient(pc, vocab=vocab, dim=dim, name=f"{prefix}_cli")

    def close():
        for svc in svcs:
            psserve.unregister_psserve(svc)
        for s in servers:
            s.stop()
            s.join()
    return shards, cli, close


def trainer_wire(dev, card):
    """Step 13 (see the module docstring): DataParallelTrainer through the
    wire, a faulted run, and bench.py's wave pairs."""
    import brpc_tpu_torch.fault as fault
    from brpc_tpu_torch.models.parameter_server import PSConfig
    from brpc_tpu_torch.train import OptimizerSpec
    from brpc_tpu_torch.train.trainer import DataParallelTrainer
    spec = OptimizerSpec("adam", lr=0.01)
    out = {"card": card}

    def run(label, plan=None):
        cfg = PSConfig(vocab=TRAINER_VOCAB, d_model=32, d_ff=64,
                       n_layers=2, seq=16, batch=8)
        embed0, dense0 = DataParallelTrainer.model_init(cfg, seed=5)
        shards, cli, close = ps_servers(dev, 2, cfg.vocab, 32,
                                        (8, 32, 128, 512), label, embed0)
        try:
            tr = DataParallelTrainer(cli, cfg, n_workers=4, steps=8,
                                     optimizer=spec, eval_every=4, seed=5,
                                     retry_backoff_s=0.01, name=label,
                                     device=dev)
            tr.seed_dense(dense0)
            if plan is None:
                rep = tr.run()
            else:
                with fault.injected(plan):
                    rep = tr.run()
            stats = [sh.stats() for sh in shards]
        finally:
            close()
        check(rep["loss_final"] < rep["loss_first"],
              f"trainer {label}: loss did not fall {rep['loss_history']}")
        check(rep["stale_reads"] == 0,
              f"trainer {label}: {rep['stale_reads']} stale reads")
        check(rep["waves"] == 4 * 8,
              f"trainer {label}: {rep['waves']} waves, not 32")
        for s in stats:
            # exactly once: one version per applied wave and push, one
            # fused apply per wave (each wave's 128 keys reach both
            # shards), retries served from the applied set
            check(s["version"] == s["updates"] + s["pushes"]
                  and s["opt_updates"] == rep["waves"],
                  f"trainer {label}: shard {s['shard_index']} version "
                  f"{s['version']}, updates {s['updates']}, pushes "
                  f"{s['pushes']}, opt updates {s['opt_updates']}")
        rep["shard_stats"] = [{k: s[k] for k in
                               ("version", "updates", "opt_updates",
                                "pushes", "dup_updates")} for s in stats]
        return rep

    out["run"] = run("smoke_tr")
    plan = fault.FaultPlan(13).on(fault.UPDATE_WAVE, fault.ERROR,
                                  times=3).on(
        fault.PS_OPT_APPLY, fault.ERROR, times=2,
        match=lambda ctx: ctx.get("stage") == "post")
    out["faulted"] = run("smoke_trf", plan)
    fr = out["faulted"]
    check(plan.injected.get(fault.UPDATE_WAVE) == 3
          and plan.injected.get(fault.PS_OPT_APPLY) == 2,
          f"trainer faulted: injected {plan.injected}")
    check(fr["wave_retries"] >= 3
          and sum(s["dup_updates"] for s in fr["shard_stats"]) >= 2,
          f"trainer faulted: retries {fr['wave_retries']}, shards "
          f"{fr['shard_stats']}")
    out["injected"] = dict(plan.injected)

    # bench.py's rung 1: _send_wave from 4 workers against the big
    # table, wire (fused on the shard) against pull_compute_push (slots
    # at the trainer), in alternating pairs
    cfg = PSConfig(vocab=WAVE_VOCAB, d_model=32, d_ff=64, n_layers=2,
                   seq=16, batch=8)
    per_shard = WAVE_KEYS // 2
    _, cli, close = ps_servers(dev, 2, WAVE_VOCAB, 32,
                               (8, 32, 128, 512, per_shard), "smoke_wave",
                               None)
    rng = np.random.default_rng(0)
    bounds = [(i * WAVE_VOCAB // 2, (i + 1) * WAVE_VOCAB // 2)
              for i in range(2)]

    def mk_keys():
        ks = np.concatenate([rng.integers(lo, hi, per_shard)
                             for lo, hi in bounds]).astype(np.int64)
        return rng.permutation(ks)

    keysets = [mk_keys() for _ in range(8)]
    gradsets = [rng.standard_normal((WAVE_KEYS, 32)).astype(np.float32)
                for _ in range(4)]

    def trial(mode, k):
        tr = DataParallelTrainer(cli, cfg, n_workers=4, steps=1,
                                 optimizer=spec, mode=mode, seed=k,
                                 name=f"smoke_wave_{mode}{k}", device=dev)
        clis = [tr._clone_client(w) for w in range(4)]
        tr._send_wave(clis[0], 0, 0, keysets[0], gradsets[0])
        stop_t = time.monotonic() + WAVE_WINDOW_S
        counts = [0] * 4

        def worker(w):
            i = 0
            while time.monotonic() < stop_t:
                tr._send_wave(clis[w], w, i, keysets[(w + i) % 8],
                              gradsets[(w + i) % 4])
                counts[w] += 1
                i += 1

        t0 = time.monotonic()
        ts = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        check(not any(t.is_alive() for t in ts),
              f"wave trial {mode}: a worker did not finish")
        return sum(counts) / (time.monotonic() - t0)

    try:
        ups = {"wire": [], "pull_compute_push": []}
        for k in range(WAVE_PAIRS):
            order = ("wire", "pull_compute_push") if k % 2 == 0 else \
                ("pull_compute_push", "wire")
            for mode in order:
                ups[mode].append(trial(mode, k))
        # one dense Pull of w_out at this width: why the trainer runs
        # above use a smaller vocabulary
        cli.push("w_out", np.zeros((32, WAVE_VOCAB), np.float32))
        t0 = time.perf_counter()
        cli.pull("w_out")
        out["dense_pull_w_out_ms"] = (time.perf_counter() - t0) * 1e3
        check(cli.n_stale_reads == 0, "wave pairs: stale reads")
    finally:
        close()
    med = {m: float(np.median(v)) for m, v in ups.items()}
    out["wave_pairs"] = {"updates_per_s": ups, "median": med,
                         "wire_over_pcp": med["wire"]
                         / med["pull_compute_push"]}
    return out


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
    print(f"profiler windows taken again (no device event seen): "
          f"{BLIND_WINDOWS[0]}", flush=True)

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

    # -- the PS and training phases: no K1/K2 on this path (torch ops)
    flagship = train_flagship(dev, card)
    phase_done("train flagship")
    r = flagship
    print(f"train flagship [{card}]: vocab 32768 d 1024 ff 4096 L8 S1024 "
          f"B8, bf16 on f32 masters, lr {r['lr']}: losses "
          f"{json.dumps([round(x, 5) for x in r['losses']])}; step 1 bf16 "
          f"vs f32: loss {r['loss_step1_bf16']:.6f} / "
          f"{r['loss_step1_f32']:.6f} (rel {r['loss_rel_diff']:.3g}, "
          f"tolerance {STEP_TOL['loss_rel']}), grads rel "
          f"{r['grad_rel_diff']:.3g} (tolerance {STEP_TOL['grad_rel']}; "
          f"per param {json.dumps({k: round(v, 5) for k, v in r['grad_rel_diff_per_param'].items()})}); "
          f"warm step {r['warm_step_ms']:.3f} ms, "
          f"{r['tokens_per_s']:.0f} tokens/s, "
          f"{r['achieved_tflops']:.1f} TFLOP/s of {r['tflop_per_step']:.3f} "
          f"TFLOP a step; bound {r['bound_ms']:.3f} ms ({r['bound_rate']}), "
          f"{100 * r['share_of_bound']:.1f}% of bound; "
          f"{r['cuda_launches_per_step']} CUDA launches a step; peak "
          f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; device busy "
          f"(profiled step) {r['profile']['device_busy_share']}; top "
          f"{json.dumps(r['profile'].get('top_kernels', [])[:5])}",
          flush=True)
    fleet = ps_fleet(dev, card, flagship_embed())
    phase_done("ps fleet")
    r = fleet
    print(f"ps fleet [{card}]: 32768x1024 f32 on {r['shards']} shards, "
          f"{r['wave_keys']}-key waves: lookup == dense, plain/sgdm/adam "
          f"== oracle_apply bit for bit, replayed token acked, stale reads "
          f"{r['stale_reads']}; lookup ms p50/p99 "
          f"{r['lookup_ms']['p50']:.2f}/{r['lookup_ms']['p99']:.2f} "
          f"({r['lookups_per_s']:.1f} lookups/s, "
          f"{r['keys_per_s_lookup']:.0f} keys/s), adam wave ms p50/p99 "
          f"{r['wave_ms']['p50']:.2f}/{r['wave_ms']['p99']:.2f} "
          f"({r['waves_per_s']:.1f} waves/s)", flush=True)
    for row in r["programs"]:
        print(f"ps program [{card}] {row['program']}: device ms "
              f"{row['device_ms']} eager {row['eager_ms']:.4f} CUDA "
              f"launches/call {row['cuda_launches_per_call']} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}) share "
              f"{100 * row['share_of_bound']:.1f}%", flush=True)
    trainer = trainer_wire(dev, card)
    phase_done("trainer wire")
    r = trainer
    print(f"trainer wire [{card}]: vocab {TRAINER_VOCAB} d 32 L2 S16 B8, 2 "
          f"shards, 4 workers, adam lr 0.01, 8 steps: loss "
          f"{r['run']['loss_first']:.5f} -> {r['run']['loss_final']:.5f} "
          f"(history {json.dumps([round(x, 5) for x in r['run']['loss_history']])}), "
          f"waves {r['run']['waves']}, stale reads "
          f"{r['run']['stale_reads']}, {r['run']['elapsed_s']:.2f} s; "
          f"faulted run (injected {json.dumps(r['injected'])}): waves "
          f"{r['faulted']['waves']}, wave retries "
          f"{r['faulted']['wave_retries']}, shards "
          f"{json.dumps(r['faulted']['shard_stats'])}", flush=True)
    wp = r["wave_pairs"]
    print(f"trainer waves [{card}]: vocab {WAVE_VOCAB} d 32, 2 shards, 4 "
          f"workers, {WAVE_KEYS}-key adam waves, {WAVE_PAIRS} alternating "
          f"pairs of {WAVE_WINDOW_S} s: updates/s wire "
          f"{json.dumps([round(x, 2) for x in wp['updates_per_s']['wire']])}"
          f" pull_compute_push "
          f"{json.dumps([round(x, 2) for x in wp['updates_per_s']['pull_compute_push']])}"
          f"; medians {json.dumps({k: round(v, 2) for k, v in wp['median'].items()})}"
          f", wire/pcp {wp['wire_over_pcp']:.3f}; one JSON Pull of w_out "
          f"[32, {WAVE_VOCAB}] {r['dense_pull_w_out_ms']:.1f} ms",
          flush=True)

    # -- step 14: KV migration and disaggregated serving, (b) again
    served_migration = serve_migration(dev, cfg_b, ctx_b, card, served_rpc)
    phase_done("serve migration")
    r = served_migration
    dg, fo = r["disagg"], r["failover"]
    print(f"serve b migration [{card}]: {r['pages_per_prompt']} pages "
          f"({r['pages_per_prompt'] * cfg_b.kv_bytes_per_token * r['page_tokens'] / 2**20:.1f}"
          f" MiB) a prompt, migrate ms p50/p99 "
          f"{r['migrate_ms']['p50']:.2f}/{r['migrate_ms']['p99']:.2f}, "
          f"{r['migrate_pages_per_s']:.1f} pages/s, "
          f"{r['migrate_mb_per_s']:.1f} MiB/s; splice p99 "
          f"{r['splice_p99_us']:.0f} us; host-serialized "
          f"{r['host_serialized_mb']:.1f} MiB in "
          f"{r['fallback_migrations']} migrations, zero_copy "
          f"{r['zero_copy']}; R1 from migrated pages: least prefix hit "
          f"{r['r1_min_prefix_hit']}, TTFT p50 {r['r1_ttft_ms_p50']:.1f} ms; "
          f"fetch TTFT p50 {r['fetch_ttft_ms_p50']:.1f} ms against a cold "
          f"prefill {r['cold_ttft_ms_p50']:.1f} ms on the same replica "
          f"(least hit {r['fetch_min_prefix_hit']}; {r['fetch_streams']} "
          f"streams at once, pass {r['fetch_pass_s']:.3f} s against "
          f"{r['cold_pass_s']:.3f} s cold); rebalance "
          f"{json.dumps(r['rebalance'])}", flush=True)
    print(f"serve b disagg [{card}]: 8 concurrent {NEW_TOKENS}-token "
          f"generations across two processes: TTFT p50 "
          f"{dg['ttft_ms_p50']:.1f} ms (of it the Prefill call, p50 "
          f"{dg['prefill_call_ms_p50']:.1f} ms), "
          f"{dg['tokens_per_s']:.1f} tok/s "
          f"(one replica over RPC, step 6: TTFT ms "
          f"{json.dumps(dg['single_replica_rpc_ttft_ms'])}, tok/s "
          f"{json.dumps(dg['single_replica_rpc_tokens_per_s'])}); least "
          f"decode prefix hit {dg['min_decode_prefix_hit']}; paged calls in "
          f"the prefill process {dg['prefill_paged_calls']}; prefill "
          f"process busy (profiled pass) "
          f"{dg['profile']['device_busy_share']}; decode process "
          f"{json.dumps(dg['decode_process'])}", flush=True)
    print(f"serve b failover [{card}]: crash after "
          f"{fo['tokens_before_crash']} tokens -> first resumed token "
          f"{fo['crash_to_first_resumed_token_ms']:.1f} ms, resume prefix "
          f"hit {fo['resume_prefix_hit']}, sync {json.dumps(fo['sync'])}; "
          f"phase wall {r['wall_s']:.1f} s (references {r['refs_s']:.1f} "
          f"s); launches {r['launches']} ({r['paged_cuda_launches']} paged "
          f"CUDA)", flush=True)
    for row in r["device_rows"]:
        print(f"migration program [{card}] {row['program']}: device ms "
              f"{row['device_ms']} eager {row['eager_ms']:.4f}"
              + (f" CUDA launches/call {row['cuda_launches_per_call']} "
                 f"bound {row['bound_ms']:.5f} ({row['bound_by']}) share "
                 f"{100 * row['share_of_bound']:.1f}%"
                 if "bound_ms" in row else ""), flush=True)
    # -- step 15: the HTTP face and the console, (b) again
    served_http = serve_http(dev, cfg_b, ctx_b, card, served_rpc,
                             served_control)
    check_rings("serve http", rings0)
    phase_done("serve http")
    r = served_http
    pm, sm, sp = r["pair_medians"], r["score_medians"], r["sampler_medians"]
    print(f"serve b http [{card}]: /serving/generate, 8 streams of "
          f"{NEW_TOKENS} tokens: cold {r['cold_tokens_per_s']:.1f} tok/s, "
          f"warm {r['warm_tokens_per_s']:.1f} (native hot path off "
          f"{r['python_hot_path_tokens_per_s']:.1f}), TTFT ms "
          f"{json.dumps(r['ttft_ms'])}, gap ms {json.dumps(r['gap_ms'])}; "
          f"{HTTP_PAIRS} alternating warm HTTP/TRPC pairs on the same "
          f"engine, medians {json.dumps(pm)}, HTTP/TRPC tok/s "
          f"{json.dumps([round(x, 4) for x in r['http_over_trpc']])} "
          f"(step 6 TRPC warm {r['step6_trpc']['warm_tokens_per_s']:.1f} "
          f"tok/s, TTFT ms {json.dumps(r['step6_trpc']['ttft_ms'])})",
          flush=True)
    print(f"serve b http score [{card}]: {REST_PAIRS} alternating pairs of "
          f"8 rows, POST /Serving/Score against ScoreT, medians "
          f"{json.dumps(sm)} (step 7 ScoreT "
          f"{r['step7_scoret']['rows_per_s']:.1f} rows/s, latency ms "
          f"{json.dumps(r['step7_scoret']['latency_ms'])})", flush=True)
    print(f"serve b http console [{card}]: {r['console_scrapes']} scrapes "
          f"of {len(CONSOLE_PAGES)} pages under a warm pass, ms "
          f"{json.dumps(r['console_scrape_ms'])}; hotspot sampler "
          f"{SAMPLER_PAIRS} alternating off/on pairs, median tok/s "
          f"{json.dumps(sp)}, on/off "
          f"{json.dumps([round(x, 4) for x in r['sampler_on_over_off']])}, "
          f"one pass {r['sampler_pass_ms']:.3f} ms over "
          f"{r['sampler_threads_walked']} threads; "
          f"routes {sum(v == 200 for v in r['routes'].values())} x 200, "
          f"{sum(v == 501 for v in r['routes'].values())} x 501; phase wall "
          f"{r['wall_s']:.1f} s; launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)
    # -- step 16: request dumps and replay, the span database, the
    # flight recorder, (b) again
    served_capture = serve_capture(dev, cfg_b, ctx_b, card)
    check_rings("serve capture", rings0)
    phase_done("serve capture")
    r = served_capture
    print(f"serve b capture [{card}]: rpc_dump {r['dump_records']} records "
          f"for {json.dumps(r['dumped_calls'])}; run_replay against a "
          f"second server {json.dumps(r['replay'])}; replayed ScoreT rows "
          f"max abs diff {r['replayed_score_max_abs_diff']} against the "
          f"original answers; {r['replayed_generates']} Generate records "
          f"replayed without their client stream answered "
          f"{json.dumps(r['replayed_generate_answers'])}; span trees from "
          f"disk equal to the ring's, spans each "
          f"{json.dumps(r['span_trees_from_disk'])}; flight threads "
          f"{json.dumps(r['flight_threads'])}, their last events "
          f"{json.dumps(r['flight_last_events'])}, syscalls "
          f"{json.dumps(r['syscalls'])}", flush=True)
    print(f"serve b capture cost [{card}]: {CAPTURE_PAIRS} pairs of warm "
          f"8-stream passes, dump+span database+flight recorder off and "
          f"on (off first in pairs 1, 3, 5), tok/s {json.dumps(r['cost_tokens_per_s'])}, on/off "
          f"{json.dumps([round(x, 4) for x in r['cost_on_over_off']])}, "
          f"median {pct(r['cost_on_over_off'], 50):.4f}; phase wall "
          f"{r['wall_s']:.1f} s; launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)
    # -- step 17: the cluster front door, (b) again
    served_router = serve_router(dev, cfg_b, ctx_b, card)
    check_rings("serve router", rings0)
    phase_done("serve router")
    r = served_router
    rk, rr = r["replica_kill"], r["router_restart"]
    print(f"serve b router [{card}]: 8 sessions of {NEW_TOKENS} tokens "
          f"through the ClusterRouter over 2 replicas (placement "
          f"{json.dumps(r['placement'])}): cold "
          f"{r['cold_tokens_per_s']:.1f} tok/s, warm "
          f"{r['warm_tokens_per_s']:.1f}, TTFT p50 ms "
          f"{json.dumps(r['ttft_ms'])}; {ROUTER_PAIRS} alternating warm "
          f"pairs router/direct to one replica, tok/s "
          f"{json.dumps(r['pair_tokens_per_s'])}, TTFT p50 ms "
          f"{json.dumps(r['pair_ttft_ms_p50'])}, router/direct "
          f"{json.dumps([round(x, 4) for x in r['router_over_direct']])}; "
          f"one router pass with the telemetry pulls off "
          f"{r['pulls_off_tokens_per_s']:.1f} tok/s", flush=True)
    print(f"serve b router faults [{card}]: shed at level 3 "
          f"E{r['shed']['code']} retry_after_s "
          f"{r['shed']['retry_after_s']}; replica kill after {KILL_AFTER} "
          f"tokens -> first resumed token {rk['stall_ms']:.1f} ms, "
          f"re-decoded {rk['session']['re_decoded_tokens']} of "
          f"{len(ctx_b['prompts'][0]) + NEW_TOKENS} tokens, replicated "
          f"pages {rk['session']['replicated_pages']}; router SIGKILL "
          f"after {KILL_AFTER} tokens of {RESTART_STREAMS} sessions -> "
          f"successor up {rr['kill_to_successor_up_ms']:.1f} ms, first "
          f"resumed tokens ms "
          f"{json.dumps([round(x, 1) for x in rr['kill_to_first_resumed_token_ms']])}"
          f", epochs {rr['epochs']}, WAL replay "
          f"{json.dumps(rr['wal_replay'])}; buddy pushes (migrations, "
          f"pages) {json.dumps(r['buddy_pushes'])}; phase wall "
          f"{r['wall_s']:.1f} s; launches {r['launches']} "
          f"({r['paged_cuda_launches']} paged CUDA)", flush=True)
    print(f"phase seconds [{card}]: {json.dumps(phase_s)}", flush=True)
    print(f"profiler windows taken again, whole script: "
          f"{BLIND_WINDOWS[0]}", flush=True)

    def entry(name, source, replaces, rows, main_row):
        m = rows[main_row]
        err = max(r["max_abs_err"] for r in rows)
        launches = sum(r["launches"][name] for r in
                       served + speculative + [served_rpc, served_control,
                                               served_host, served_replicas,
                                               served_migration, served_http,
                                               served_capture, served_router])
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
              "replicas_serving": served_replicas,
              "train_flagship": flagship, "ps_fleet": fleet,
              "trainer_wire": trainer,
              "migration_serving": served_migration,
              "http_serving": served_http,
              "capture_serving": served_capture,
              "router_serving": served_router, "phase_s": phase_s,
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
