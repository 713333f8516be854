"""TrafficArbiter and MixedWorkloadHarness: one fleet, every traffic
shape (a copy of ``brpc_tpu/train/arbiter.py``).

The harness is one in-process fleet serving, at the same time,

  * zipf ``PS.Lookup`` reads (the online serving shape),
  * streamed ``Serving.Generate`` decodes (bit-exact token streams),
  * trainer ``PS.Update`` waves (the background shape),

with the :class:`TrafficArbiter` arbitrating ACROSS shapes on one
OverloadLadder.  Its two cheapest rungs act on the TRAINER:

  level 1  ``pace_trainer``     inject delay before each update wave
  level 2  ``shed_trainer``     hold waves entirely until calm
  level 3  ``brownout_batcher`` first rung that touches SERVING
  level 4  ``clamp_engine``     clamp new generations' budgets

so under a pressure ramp the gradient degrades cheapest first: the
ladder's ``first_fired`` ticks show pace_trainer firing strictly before
any serving rung, and its ``escalations`` show trainer waves absorbing
overload while serving traffic runs untouched.

CLUSTER FLOOR TIER.  The router pushes its gradient level to every
replica's ``_cluster`` service each tick; the arbiter reads that floor
as an external level source (:meth:`TrafficArbiter.
add_cluster_floor_source`, :meth:`~TrafficArbiter.bind_cluster_service`):
any router-pushed floor >= 1 raises the arbiter's effective level to
shed_trainer, holding update waves fleet-wide before any serving rung
fires anywhere.  ``n_cluster_held_waves`` counts the waves held by the
floor alone (local ladder calm).

The harness also carries the chaos hooks: ``kill_shard`` mid-wave and
``restart_shard`` (the same shard STATE, a fresh server), with the
``update_token`` replay discipline keeping momentum steps exactly once.
Its PS shards, their fused optimizer apply and the replicas' KV stores
live on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

from .. import errors
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder
from ..serving.ladder import OverloadLadder

ARBITER_LEVEL_NAMES = ("pace_trainer", "shed_trainer",
                       "brownout_batcher", "clamp_engine")

# metric names match ReplicaHandle.pressures() so the same pressure
# dicts drive either ladder.  Calibrated so a saturated-but-serving
# closed loop sits at pace_trainer at most; shed and the serving rungs
# need real queue growth (tests drive ordering with synthetic ramps)
DEFAULT_ARBITER_THRESHOLDS = (
    {"queue_delay_us": 10_000.0, "queue_depth": 8.0},     # pace_trainer
    {"queue_delay_us": 50_000.0, "queue_depth": 32.0},    # shed_trainer
    {"queue_delay_us": 150_000.0, "queue_depth": 128.0,   # brownout
     "pool_ratio": 0.92},
    {"queue_delay_us": 500_000.0, "pool_ratio": 0.98},    # clamp
)

PACED_WAVES = Adder("train_arbiter_paced_waves")
SHED_WAVES = Adder("train_arbiter_shed_waves")
ADMITTED_WAVES = Adder("train_arbiter_admitted_waves")


class TrafficArbiter:
    """The mixed-shape overload policy: an OverloadLadder whose two
    cheapest rungs pace/shed TRAINER waves before any serving
    component is touched (see module docstring).

    The trainer calls :meth:`admit_wave` before each update wave; a
    background tick thread (:meth:`start`) — or an explicit driver
    calling :meth:`tick` — advances the ladder from ``pressure_fn``'s
    readings and drives the serving-tier actions (batcher brownout,
    engine clamp) exactly like
    :func:`~brpc_tpu_torch.serving.ladder.apply_level_to_components`.
    """

    def __init__(self, *, thresholds=DEFAULT_ARBITER_THRESHOLDS,
                 hysteresis_ticks: int = 3,
                 tick_interval_s: float = 0.02,
                 pace_delay_s: float = 0.005,
                 shed_poll_s: float = 0.01,
                 shed_timeout_s: float = 30.0,
                 batchers=(), engines=(), pressure_fn=None,
                 clamp_new_tokens: int = 32, name: str = "arbiter",
                 cluster_floor_sources=()):
        self.ladder = OverloadLadder(thresholds,
                                     hysteresis_ticks=hysteresis_ticks,
                                     level_names=ARBITER_LEVEL_NAMES[
                                         :len(thresholds)])
        self.tick_interval_s = float(tick_interval_s)
        self.pace_delay_s = float(pace_delay_s)
        self.shed_poll_s = float(shed_poll_s)
        self.shed_timeout_s = float(shed_timeout_s)
        self.batchers = list(batchers)
        self.engines = list(engines)
        self.pressure_fn = pressure_fn
        self.clamp_new_tokens = int(clamp_new_tokens)
        self.name = str(name)
        self._mu = InstrumentedLock("train.arbiter")
        self._browned = False
        self._clamped = False
        self._thread = None
        self._stop = threading.Event()
        self.n_paced_waves = 0
        self.n_shed_waves = 0
        self.n_admitted_waves = 0
        self.n_brownouts = 0
        self.n_clamps = 0
        # the cluster floor tier: external level sources — the
        # router-pushed ``_cluster`` floor this process has latched
        self._floor_sources = list(cluster_floor_sources)
        self.n_cluster_held_waves = 0

    # ---- the cluster floor tier ----

    def add_cluster_floor_source(self, fn) -> "TrafficArbiter":
        """Register a zero-arg callable returning the cluster overload
        floor this process currently sees (a failing source reads as
        0 — a dead floor never wedges the trainer)."""
        self._floor_sources.append(fn)
        return self

    def bind_cluster_service(self, svc) -> "TrafficArbiter":
        """Consume a replica-side
        :class:`~brpc_tpu_torch.serving.cluster_control.ClusterControlService`
        as a floor source: the router pushes its gradient level there
        every tick, so the trainer co-located with this replica yields
        fleet-wide within one tick."""
        return self.add_cluster_floor_source(lambda: svc.level)

    def cluster_floor(self) -> int:
        """The highest router-pushed floor across sources."""
        floor = 0
        for fn in self._floor_sources:
            try:
                floor = max(floor, int(fn() or 0))
            except Exception:
                pass
        return floor

    def effective_level(self) -> int:
        """The level :meth:`admit_wave` gates on: the local ladder,
        raised to shed_trainer (2) whenever ANY cluster floor >= 1 — a
        router already shaping serving traffic means background waves
        must hold everywhere, the cheapest relief the fleet has."""
        lvl = self.ladder.level
        if self._floor_sources and self.cluster_floor() >= 1:
            lvl = max(lvl, 2)
        return lvl

    # ---- the ladder tick ----

    def pressures(self) -> dict:
        if self.pressure_fn is not None:
            try:
                return dict(self.pressure_fn() or {})
            except Exception:
                return {}
        return {}

    def tick(self, pressures: Optional[dict] = None) -> int:
        """One ladder tick: escalate/de-escalate from ``pressures``
        (default: ``pressure_fn()``) and drive the serving-tier
        actions.  The trainer tier needs no push — waves consult
        :meth:`admit_wave` themselves."""
        p = self.pressures() if pressures is None else pressures
        with self._mu:
            lvl = self.ladder.update(p)
            if lvl >= 3 and not self._browned:
                self._browned = True
                self.n_brownouts += 1
                for b in self.batchers:
                    b.brownout = max(getattr(b, "brownout", 0), 1)
            elif lvl < 3 and self._browned:
                self._browned = False
                for b in self.batchers:
                    b.brownout = 0
            if lvl >= 4 and not self._clamped:
                self._clamped = True
                self.n_clamps += 1
                for e in self.engines:
                    e.degraded_clamp = self.clamp_new_tokens
            elif lvl < 4 and self._clamped:
                self._clamped = False
                for e in self.engines:
                    e.degraded_clamp = None
        return lvl

    def start(self) -> "TrafficArbiter":
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.tick_interval_s):
                    self.tick()

            self._thread = threading.Thread(
                target=loop, name=f"{self.name}_tick", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # ---- the trainer's gate ----

    def admit_wave(self) -> bool:
        """Called by the trainer before each update wave.  Blocks
        while the EFFECTIVE level sheds trainer waves (>= 2 — local
        ladder, or any cluster floor >= 1), sleeps one pace delay
        while it paces them (>= 1); returns True when the wave was
        delayed at all.  Raises ELIMIT only after ``shed_timeout_s``
        of continuous shed — background work waits, it doesn't fail
        fast."""
        delayed = False
        shed_counted = False
        cluster_counted = False
        deadline = time.monotonic() + self.shed_timeout_s
        while self.effective_level() >= 2:
            if not shed_counted:
                shed_counted = True
                with self._mu:
                    self.n_shed_waves += 1
                SHED_WAVES.add(1)
            if not cluster_counted and self.ladder.level < 2:
                # held by the ROUTER'S floor alone — the fleet-wide
                # cheapest-first proof the tests pin
                cluster_counted = True
                with self._mu:
                    self.n_cluster_held_waves += 1
            delayed = True
            if time.monotonic() > deadline:
                raise errors.RpcError(
                    errors.ELIMIT,
                    f"trainer waves shed for {self.shed_timeout_s}s "
                    f"(effective level {self.effective_level()}, "
                    f"cluster floor {self.cluster_floor()})")
            time.sleep(self.shed_poll_s)
        if self.effective_level() >= 1:
            with self._mu:
                self.n_paced_waves += 1
            PACED_WAVES.add(1)
            time.sleep(self.pace_delay_s)
            delayed = True
        with self._mu:
            self.n_admitted_waves += 1
        ADMITTED_WAVES.add(1)
        return delayed

    def stats(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "ladder": self.ladder.stats(),
                "paced_waves": self.n_paced_waves,
                "shed_waves": self.n_shed_waves,
                "admitted_waves": self.n_admitted_waves,
                "brownouts": self.n_brownouts,
                "clamps": self.n_clamps,
                "cluster_floor": self.cluster_floor(),
                "cluster_held_waves": self.n_cluster_held_waves,
            }


# ---------------------------------------------------------------------------
# the mixed-shape harness
# ---------------------------------------------------------------------------

class MixedWorkloadHarness:
    """One in-process fleet carrying zipf lookups, streamed generations
    and trainer update waves at once, arbitrated by a
    :class:`TrafficArbiter` (see the module docstring).  ``run()``
    returns the report; ``kill_shard``/``restart_shard`` are the chaos
    hooks."""

    def __init__(self, *, n_shards: int = 2, vocab: int = 128,
                 dim: int = 16, n_replicas: int = 1,
                 lookup_workers: int = 2, lookup_keys: int = 16,
                 zipf_s: float = 1.0, gen_workers: int = 1,
                 gen_tokens: int = 16, train_workers: int = 2,
                 train_steps: int = 6, optimizer=None,
                 trainer_mode: str = "wire", max_lag: int = 1,
                 min_duration_s: float = 0.0, seed: int = 0,
                 arbiter: Optional[TrafficArbiter] = None,
                 pressure_fn=None, timeout_ms: int = 10_000,
                 name: str = "mixed", device=None):
        from ..device import resolve_device
        from ..models.parameter_server import PSConfig
        from .optimizer import OptimizerSpec
        from .trainer import DataParallelTrainer
        self.device = resolve_device(device)
        self.n_shards = int(n_shards)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.n_replicas = int(n_replicas)
        self.lookup_workers = int(lookup_workers)
        self.lookup_keys = int(lookup_keys)
        self.zipf_s = float(zipf_s)
        self.gen_workers = int(gen_workers)
        self.gen_tokens = int(gen_tokens)
        self.min_duration_s = float(min_duration_s)
        self.seed = int(seed)
        self.timeout_ms = int(timeout_ms)
        self.name = str(name)
        self.cfg = PSConfig(vocab=self.vocab, d_model=self.dim,
                            d_ff=2 * self.dim, n_layers=2, seq=8,
                            batch=4)
        self._closed = True        # until the fleet is up
        self._spin_up()
        self._closed = False
        try:
            self.arbiter = arbiter or TrafficArbiter(
                engines=[eng for _, eng, _, _ in self.replicas],
                pressure_fn=pressure_fn or self._pressures,
                name=f"{self.name}_arbiter")
            if not self.arbiter.batchers:
                # the brownout tier: the PS lookup batchers (serving reads)
                self.arbiter.batchers = [
                    svc._lookup_b for svc in self.ps_svcs
                    if svc._lookup_b is not None]
            self.trainer = DataParallelTrainer(
                self.client, self.cfg, n_workers=int(train_workers),
                steps=int(train_steps),
                optimizer=optimizer or OptimizerSpec("sgdm", lr=0.5,
                                                     momentum=0.5),
                mode=trainer_mode, max_lag=int(max_lag),
                arbiter=self.arbiter, seed=self.seed,
                name=f"{self.name}_trainer", device=self.device)
            self.trainer.seed_dense(self._dense0)
        except BaseException:
            self.close()
            raise

    # ---- the fleet ----

    def _ps_server(self, i: int, tag: str):
        """A server for shard ``i``: ``PS`` plus ``_telemetry`` (a PS
        shard is pullable like any replica)."""
        from .. import rpc
        from ..psserve import register_psserve
        from ..serving.telemetry import register_telemetry
        s = rpc.Server()
        self.ps_svcs.append(register_psserve(
            s, self.shards[i], name=f"{self.name}_{tag}{i}"))
        register_telemetry(s, name=f"{self.name}_ps_{tag}{i}")
        s.start("127.0.0.1", 0)
        return s

    def _spin_up(self) -> None:
        from .. import rpc
        from ..psserve import EmbeddingShardServer, PSClient
        from ..tools.rpc_press import spin_up_replicas
        from .trainer import DataParallelTrainer
        embed0, dense0 = DataParallelTrainer.model_init(
            self.cfg, seed=self.seed)
        self._dense0 = dense0
        self.shards, self.ps_servers, self.ps_svcs = [], [], []
        self.pc = rpc.PartitionChannel(self.n_shards)
        for i in range(self.n_shards):
            self.shards.append(EmbeddingShardServer(
                i, self.n_shards, self.vocab, self.dim, table=embed0,
                name=f"{self.name}_ps", device=self.device))
            s = self._ps_server(i, "")
            self.ps_servers.append(s)
            self.pc.add_partition(i, rpc.Channel(
                f"127.0.0.1:{s.port}", timeout_ms=self.timeout_ms))
        self.client = PSClient(self.pc, vocab=self.vocab, dim=self.dim,
                               name=f"{self.name}_trainer_cli")
        # every shape its OWN client, so each shape's read-your-writes
        # counters stay its own
        self.lookup_client = PSClient(
            self.pc, vocab=self.vocab, dim=self.dim,
            name=f"{self.name}_lookup_cli")
        self.replicas = spin_up_replicas(
            self.n_replicas, name_prefix=f"{self.name}_srv",
            device=self.device)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        from ..psserve import unregister_psserve
        from ..tools.rpc_press import tear_down_replicas
        arbiter = getattr(self, "arbiter", None)
        if arbiter is not None:
            arbiter.stop()
        for svc in self.ps_svcs:
            unregister_psserve(svc)
        for s in self.ps_servers:
            try:
                s.stop()
                s.join()
            except Exception:
                pass
        self.pc.close()
        tear_down_replicas(self.replicas)

    # ---- chaos hooks ----

    def kill_shard(self, i: int) -> None:
        """Kill partition ``i``'s SERVER mid-flight.  The shard's STATE
        (rows, slots, version, applied ids) survives in the process: a
        crashed front end over durable state."""
        s = self.ps_servers[i]
        s.stop()
        s.join()

    def restart_shard(self, i: int) -> None:
        """Bring partition ``i`` back: the same shard object, a fresh
        server and channel.  ``add_partition`` makes the partition a
        SelectiveChannel, so fan-out retries rotate off the dead
        endpoint, and the trainer's update_token replay dedups what the
        killed server already applied."""
        from .. import rpc
        s = self._ps_server(i, "r")
        self.ps_servers[i] = s
        self.pc.add_partition(i, rpc.Channel(
            f"127.0.0.1:{s.port}", timeout_ms=self.timeout_ms))

    # ---- pressures (real readings; tests may inject a synthetic ramp
    # through pressure_fn) ----

    def _pressures(self) -> dict:
        out = {"queue_depth": 0.0}
        for svc in self.ps_svcs:
            b = svc._lookup_b
            if b is None:
                continue
            try:
                out["queue_depth"] = max(out["queue_depth"],
                                         float(b.stats()["queued"]))
                # the recorder's windowed average (its last 10 s): its
                # percentiles are cumulative and never decay, so one
                # slow spell would hold shed_trainer for good (the JAX
                # package reads the cumulative p99)
                out["queue_delay_us"] = max(
                    out.get("queue_delay_us", 0.0),
                    float(b.queue_delay_rec.latency()))
            except Exception:
                pass
        for store, _eng, _srv, _addr in self.replicas:
            try:
                # the pages live sequences hold: a warm cache is not
                # pressure (an allocation evicts it)
                out["pool_ratio"] = max(out.get("pool_ratio", 0.0),
                                        store.pool_ratio())
            except Exception:
                pass
        return out

    # ---- the generation shape ----

    def _generate(self, ch, prompt) -> Optional[list]:
        from .. import rpc
        msgs: list = []
        done = threading.Event()

        class _Collector(rpc.StreamHandler):
            def on_received_messages(self, stream, messages):
                for m in messages:
                    d = json.loads(m)
                    msgs.append(d)
                    if d.get("done"):
                        done.set()

            def on_closed(self, stream):
                done.set()

        cntl = rpc.Controller(timeout_ms=self.timeout_ms)
        rpc.stream_create(cntl, _Collector())
        resp = ch.call_sync("Serving", "Generate",
                            {"prompt": list(prompt),
                             "max_new_tokens": self.gen_tokens},
                            serializer="json", cntl=cntl)
        if not resp.get("accepted"):
            return None
        if not done.wait(30):
            return None
        return [m["token"] for m in msgs if "token" in m]

    # ---- run ----

    def run(self) -> dict:
        """Drive all three shapes until the trainer completes (and at
        least ``min_duration_s`` passed); returns the report."""
        from .. import rpc
        from ..tools.rpc_press import zipf_key_sampler
        stop = threading.Event()
        mu = threading.Lock()
        shape: dict = {
            "lookup": {"ok": 0, "err": 0, "lat_us": []},
            "generate": {"ok": 0, "err": 0, "bit_exact": 0,
                         "mismatch": 0, "lat_us": []},
        }

        # reference streams FIRST, on a quiet fleet: later generations
        # of the same prompt must be bit-exact under the mixed load
        gen_chs = [rpc.Channel(self.replicas[g % self.n_replicas][3],
                               timeout_ms=self.timeout_ms)
                   for g in range(self.gen_workers)]
        prompts = [[(self.seed + 3 * g + 1) % 97]
                   for g in range(self.gen_workers)]
        refs = [self._generate(gen_chs[g], prompts[g])
                for g in range(self.gen_workers)]
        # the pool baseline AFTER the reference runs: the prefix cache
        # keeps those chains' pages, and repeating the same prompts
        # under load must not grow occupancy past this
        for _store, eng, _srv, _addr in self.replicas:
            eng.join_idle(10)
        self._pool_base = [store.pagepool.stats()["pages_in_use"]
                           for store, _, _, _ in self.replicas]

        def lookup_loop(w):
            sample = zipf_key_sampler(self.vocab, self.zipf_s,
                                      seed=self.seed * 31 + w)
            st = shape["lookup"]
            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    self.lookup_client.lookup(sample(self.lookup_keys))
                    with mu:
                        st["ok"] += 1
                        st["lat_us"].append((time.monotonic() - t0) * 1e6)
                except errors.RpcError:
                    with mu:
                        st["err"] += 1

        def gen_loop(g):
            st = shape["generate"]
            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    toks = self._generate(gen_chs[g], prompts[g])
                except errors.RpcError:
                    toks = None
                with mu:
                    if toks is None:
                        st["err"] += 1
                        continue
                    st["ok"] += 1
                    st["lat_us"].append((time.monotonic() - t0) * 1e6)
                    if refs[g] is not None and toks == refs[g]:
                        st["bit_exact"] += 1
                    else:
                        st["mismatch"] += 1

        self.arbiter.start()
        threads = [threading.Thread(target=lookup_loop, args=(w,),
                                    daemon=True,
                                    name=f"{self.name}_lookup{w}")
                   for w in range(self.lookup_workers)]
        threads += [threading.Thread(target=gen_loop, args=(g,),
                                     daemon=True,
                                     name=f"{self.name}_gen{g}")
                    for g in range(self.gen_workers)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        try:
            train_report = self.trainer.run()
        finally:
            remain = self.min_duration_s - (time.monotonic() - t0)
            if remain > 0:
                time.sleep(remain)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            self.arbiter.stop()
            for ch in gen_chs:
                ch.close()
        elapsed = time.monotonic() - t0

        def lat(st):
            xs = st.pop("lat_us")
            st["p50_us"] = float(np.percentile(xs, 50)) if xs else None
            st["p99_us"] = float(np.percentile(xs, 99)) if xs else None
            st["qps"] = st["ok"] / max(elapsed, 1e-9)

        with mu:
            lat(shape["lookup"])
            lat(shape["generate"])

        # invariants: exactly-once applies (each shard's version counter
        # equals its distinct applies), read-your-writes clean, queues
        # drained, pools at their baseline
        drained = all(
            b is None or b.stats()["queued"] == 0
            for svc in self.ps_svcs
            for b in (svc._lookup_b, svc._update_b, svc._update_tb))
        pools_ok = True
        for i, (store, eng, _srv, _addr) in enumerate(self.replicas):
            eng.join_idle(10)
            now = store.pagepool.stats()["pages_in_use"]
            pools_ok = pools_ok and now == self._pool_base[i]
        return {
            "elapsed_s": elapsed,
            "shapes": shape,
            "train": train_report,
            "arbiter": self.arbiter.stats(),
            "shards": [sh.stats() for sh in self.shards],
            "exactly_once": [sh.version == sh.n_updates + sh.n_pushes
                             for sh in self.shards],
            "stale_reads": (self.trainer.stale_reads()
                            + self.lookup_client.n_stale_reads),
            "queues_drained": drained,
            "pools_at_baseline": pools_ok,
        }
