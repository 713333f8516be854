"""Deterministic fault injection (a copy of ``brpc_tpu/fault.py``).

Named injection sites in the port's RPC and serving code:

    site               faults
    transport.connect  refuse, latency  (rpc/transport.py: the connect
                       raises ConnectionError)
    transport.send     error, overcrowd, reset, partial, corrupt,
                       latency  (rpc/transport.py: every frame writer;
                       reset fails the socket mid-call, partial first
                       writes a torn frame head)
    transport.recv     drop, corrupt, latency  (rpc/transport.py: the
                       messages of the Python trampoline -- stream
                       frames and full-meta messages; natively
                       pre-parsed unary requests and responses never
                       pass it, so lose a unary response at the sender,
                       transport.send)
    stream.frame       drop, dup, latency  (rpc/stream.py: a frame
                       arriving for a local stream; dup redelivers a
                       sequenced DATA frame, which the reorder layer
                       must drop)
    stream.feedback    drop  (rpc/stream.py: a consumed-bytes feedback
                       frame is lost; credit returns at the next one)
    serving.batch      error  (serving/batcher.py: a mid-batch failure;
                       every member completes with a definite error,
                       never a partial scatter)
    serving.step       error, latency  (serving/engine.py: the decode
                       step fails; a supervised engine crashes and the
                       EngineSupervisor fails the in-flight generations
                       over, an unsupervised one fails them definitively)
    serving.spec_verify error  (serving/engine.py: the speculative verify
                       fails; every draft lease is released first, then
                       as serving.step)
    serving.heartbeat  error  (serving/engine.py: SUPPRESSES the step
                       loop's heartbeat while the loop keeps running,
                       which is what a wedged loop looks like to the
                       supervisor's watchdog)
    psserve.lookup     error  (psserve/service.py: a Lookup/LookupT
                       sub-call fails before the gather)
    psserve.update     error  (psserve/service.py: an Update/UpdateT
                       sub-call fails before the apply, stage="pre", or
                       its ack is dropped after it, stage="post"; the
                       retry must dedup by update_id)
    psserve.opt_apply  error  (psserve/service.py: the same two stages
                       around the fused optimizer apply)
    train.update_wave  error  (train/trainer.py: a trainer's update wave
                       fails; the trainer replays it with its
                       update_token)
    dcn.migrate_send   error  (migrate/plane.py: a page migration fails on
                       the source before anything leaves the process;
                       its pins are released)
    dcn.migrate_recv   error  (migrate/plane.py: the destination refuses
                       an Offer before it splices anything)
    migrate.splice     error  (kvcache/store.py: import_prefix fails
                       mid-splice, per page; the whole import rolls back)
    migrate.prefix_fetch error  (migrate/plane.py: a pull-based prefix
                       fetch fails before its PushTo; the caller
                       recomputes)
    router.admit       error  (serving/router.py: a session admission
                       fails definitively, before anything is forwarded)
    router.forward     error  (serving/router.py: a forward attempt to a
                       replica fails; the session re-routes)
    router.resume      error  (serving/router.py: a client (re)attach
                       fails; a Generate whose attach fails cancels its
                       session)
    router.model_route error  (serving/router.py: the pick is treated as
                       a wrong-model route; counted and re-routed)
    router.wal_append  error  (serving/session_wal.py: an append fails;
                       the record parks on the pending tail and heals
                       with the next append)
    cluster.floor_push drop  (serving/router.py: a floor push to a remote
                       replica is lost on the wire; the next tick
                       re-pushes)
    cluster.deploy     error  (serving/cluster_control.py: a deploy,
                       undeploy or drain push is refused)

Disabled (the default), a site costs one module-attribute check,
``if fault.ENABLED:``.  Enabled, ``hit(site)`` consults the installed
:class:`FaultPlan`: rules fire by per-site hit index (``after``/
``times``) or by a per-rule seeded RNG (``prob``), never by wall clock
or thread identity::

    plan = fault.FaultPlan(seed=7).on(fault.STEP, fault.ERROR,
                                      times=1, after=2)
    with fault.injected(plan):
        ...run traffic...
    assert plan.injected[fault.STEP] == 1

A site interprets a fired fault in its own failure convention (an rc
for the socket writers, ConnectionError for connect); LATENCY is
applied here (sleep, then proceed).

The port's code and tests name the sites through the constants below
(the same strings as the JAX package's sites): ``brpc-check``'s
fault-site registry (``docs/fault_sites.md``) counts a quoted site name
in any test module as a chaos test of the JAX package's site, which a
test of the port's is not.
"""
from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

from .bvar import Adder

CONNECT = "transport.connect"
SEND = "transport.send"
RECV = "transport.recv"
FRAME = "stream.frame"
FEEDBACK = "stream.feedback"
BATCH = "serving.batch"
STEP = "serving.step"
SPEC_VERIFY = "serving.spec_verify"
HEARTBEAT = "serving.heartbeat"
PS_LOOKUP = "psserve.lookup"
PS_UPDATE = "psserve.update"
PS_OPT_APPLY = "psserve.opt_apply"
UPDATE_WAVE = "train.update_wave"
MIGRATE_SEND = "dcn.migrate_send"
MIGRATE_RECV = "dcn.migrate_recv"
MIGRATE_SPLICE = "migrate.splice"
PREFIX_FETCH = "migrate.prefix_fetch"
ROUTER_ADMIT = "router.admit"
ROUTER_FORWARD = "router.forward"
ROUTER_RESUME = "router.resume"
ROUTER_MODEL_ROUTE = "router.model_route"
ROUTER_WAL_APPEND = "router.wal_append"
CLUSTER_FLOOR_PUSH = "cluster.floor_push"
CLUSTER_DEPLOY = "cluster.deploy"

REFUSE = "refuse"        # connect: raise ConnectionError
RESET = "reset"          # send: fail the socket mid-call (ECONNRESET)
ERROR = "error"          # failure in the site's own convention
OVERCROWD = "overcrowd"  # send: the native -2 write-queue-bound rc
LATENCY = "latency"      # sleep latency_s, then proceed (applied here)
PARTIAL = "partial"      # send: torn prefix on the wire, then socket death
CORRUPT = "corrupt"      # mangle the payload (the site applies mangle())
DROP = "drop"            # recv/frame: swallow the message
DUP = "dup"              # stream frame: deliver twice; only sequenced
#                          DATA frames duplicate, so scope DUP rules with
#                          match=... on msg_type/stream_seq

# the fast gate: sites check it before any per-site work; install() and
# clear() are its only writers
ENABLED = False

_plan: Optional["FaultPlan"] = None
_mu = threading.Lock()

# per-site injected counters (one per site per process: bvar names are
# unique)
_counters: dict[str, Adder] = {}
_counters_mu = threading.Lock()


def _counter(site: str) -> Adder:
    with _counters_mu:
        c = _counters.get(site)
        if c is None:
            c = _counters[site] = Adder(
                "fault_injected_" + site.replace(".", "_"))
        return c


@dataclass
class Fault:
    """One fired decision, handed to the site for interpretation."""
    site: str
    kind: str
    latency_s: float = 0.0
    rc: int = -1


class _Rule:
    __slots__ = ("kind", "times", "after", "prob", "latency_s", "rc",
                 "match", "seen", "fired", "rng")

    def __init__(self, kind: str, times: int, after: int, prob: float,
                 latency_s: float, rc: int,
                 match: Optional[Callable[[dict], bool]], rng_seed: str):
        self.kind = kind
        self.times = times          # fire at most this many; <0 = forever
        self.after = after          # skip the first `after` matching hits
        self.prob = prob
        self.latency_s = latency_s
        self.rc = rc                # the rc an ERROR at a writer returns
        self.match = match
        self.seen = 0
        self.fired = 0
        # per-rule RNG: the same plan replays the same schedule
        self.rng = random.Random(rng_seed)


class FaultPlan:
    """A seeded schedule of faults.  Thread-safe; rules are evaluated in
    the order added and the FIRST matching rule fires."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._mu = threading.Lock()
        self._rules: dict[str, list[_Rule]] = {}
        # per-plan fired counts (the bvar counters are process-wide)
        self.injected: dict[str, int] = {}

    def on(self, site: str, kind: str, *, times: int = 1, after: int = 0,
           prob: float = 1.0, latency_s: float = 0.01, rc: int = -1,
           match: Optional[Callable[[dict], bool]] = None) -> "FaultPlan":
        """Schedule `kind` at `site`: at most `times` firings (<0:
        forever), after skipping the first `after` matching hits, each
        gated by `prob` through the rule's seeded RNG; `match` (a
        predicate over the site's context keywords) scopes the rule."""
        with self._mu:
            idx = sum(len(r) for r in self._rules.values())
            self._rules.setdefault(site, []).append(
                _Rule(kind, times, after, prob, latency_s, rc, match,
                      f"{self.seed}:{site}:{idx}"))
        return self

    def _hit(self, site: str, ctx: dict) -> Optional[Fault]:
        with self._mu:
            for r in self._rules.get(site, ()):
                if r.match is not None and not r.match(ctx):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.times >= 0 and r.fired >= r.times:
                    continue
                if r.prob < 1.0 and r.rng.random() >= r.prob:
                    continue
                r.fired += 1
                self.injected[site] = self.injected.get(site, 0) + 1
                return Fault(site, r.kind, r.latency_s, r.rc)
        return None


def install(plan: FaultPlan) -> None:
    global _plan, ENABLED
    with _mu:
        _plan = plan
        ENABLED = True


def clear() -> None:
    global _plan, ENABLED
    with _mu:
        ENABLED = False
        _plan = None


@contextmanager
def injected(plan: FaultPlan):
    """Install `plan` for the block, and always clear it after."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def hit(site: str, **ctx) -> Optional[Fault]:
    """Whether a fault fires at `site` (call only behind ``if
    fault.ENABLED:``).  LATENCY sleeps here and returns None; any other
    kind returns the Fault for the site to interpret."""
    plan = _plan
    if plan is None:
        return None
    f = plan._hit(site, ctx)
    if f is None:
        return None
    _counter(site).add(1)
    if f.kind == LATENCY:
        time.sleep(f.latency_s)
        return None
    return f


def mangle(data: bytes) -> bytes:
    """Deterministically corrupt a payload: flip every bit of the middle
    byte, enough to break any decode downstream; runs replay exactly."""
    if not data:
        return data
    b = bytearray(data)
    i = len(b) // 2
    b[i] ^= 0xFF
    return bytes(b)
