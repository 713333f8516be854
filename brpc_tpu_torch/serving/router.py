"""The cluster front door: resumable client sessions and one overload
gradient across N serving replicas (a copy of
``brpc_tpu/serving/router.py``).

The :class:`ClusterRouter` composes pieces the port already has:

ROUTING.  A :class:`~brpc_tpu_torch.rpc.combo_channels.SelectiveChannel`
over one ``Channel`` per replica, its selection delegated to a
:class:`~brpc_tpu_torch.policy.load_balancer.PrefixAffinityLB`: prompts
route by prefix fingerprint to the replica whose radix tree holds their
pages, broken and quarantined replicas are walked past on the ring
(remapping ONLY their share of prefixes), and every attempt's outcome
feeds the balancer and the global circuit breaker.  Repeated forward
failures quarantine a replica the way the supervisor quarantines a
flapping engine.

RESUMABLE SESSIONS.  Every generation through the router is a SESSION:
a durable ``session_id`` plus the emitted-token record, which IS the
resume cursor.  The record lives in a caller-owned :class:`SessionTable`
that survives router restarts (and, with a
:class:`~brpc_tpu_torch.serving.session_wal.SessionWAL`, router process
deaths).  On any interruption --

  * the CLIENT drops: the generation keeps decoding; tokens accumulate
    in the session record;
  * the REPLICA dies mid-decode: the router re-routes (prefix affinity
    first, any healthy replica as fallback) and resumes from ``prompt +
    emitted``, bit-exact because decode restarts at the exact (token,
    position) cursor, riding prefill-skip and page migration for the
    committed prefix;
  * the ROUTER restarts: a router adopting the same table suspends the
    in-flight sessions and resumes each on its client's reconnect --

the client reconnects with its ``session_id`` and cursor and receives
exactly the tokens past its cursor: replayed from the record first, live
after.

With ``replicate_sessions=True`` the router also coordinates migration:
at page boundaries it asks the serving replica to push the session's
committed full pages to its ring BUDDIES (where a failover would land)
over ``_kvmig``'s ``PushTo``, so a resume after a replica kill
prefix-hits pages that crossed before the crash and
``re_decoded_tokens < total``.

THE OVERLOAD GRADIENT.  One :class:`~brpc_tpu_torch.serving.ladder.
OverloadLadder` over cluster-wide pressures, four levels, each shedding
at the cheapest layer that still relieves the pressure:

  level 1  SHED AT ROUTER -- new sessions refused with ELIMIT and a
           ``retry_after_s`` hint before anything is forwarded (driven
           by the concurrency limiter and the session-capacity ratio);
  level 2  + BROWNOUT AT BATCHER -- replicas shed their deadline-less
           lane at admission;
  level 3  + CLAMP AT ENGINE -- new generations' budgets clamped;
  level 4  + EVICT AT STORE -- cache eviction every tick.

In-process replicas are driven directly (a supervisor is held at a floor
one below the cluster level); remote ones through the ``_cluster``
service's epoch-fenced ``SetFloor``.  Per-level fire counters show shed
fires before brownout before clamp before evict, and hysteresis
de-escalates in reverse.

Fault sites: ``fault.ROUTER_ADMIT``, ``ROUTER_FORWARD``,
``ROUTER_RESUME``, ``ROUTER_MODEL_ROUTE`` and ``CLUSTER_FLOOR_PUSH``.
The ``/cluster`` console page renders :meth:`ClusterRouter.stats`.
"""
from __future__ import annotations

import json
import re
import threading
from ..butil.lockprof import InstrumentedLock
import time
import uuid
from collections import deque
from typing import Callable, Optional, Sequence

from .. import errors, fault, rpcz
from ..bvar import Adder, PassiveStatus
from ..rpc.service import Service, method
from ..serving.ladder import OverloadLadder
from ..serving.modelplane import (DEFAULT_MODEL, CanarySplit,
                                         ModelCatalog, ModelMetrics,
                                         model_fingerprint,
                                         parse_deployments)

ROUTER_SERVICE = "Router"

# what each gradient level DOES, cheapest first — the /cluster page and
# the ordering tests key off these names
LEVEL_ACTIONS = ("shed_at_router", "brownout_at_batcher",
                 "clamp_at_engine", "evict_at_store")

# default cluster ladder: level i fires when ANY metric crosses its
# bound.  sessions_ratio = live sessions / capacity; the replica_*
# metrics are the MAX over local replica handles (same quantities the
# supervisor's in-process ladder reads).
DEFAULT_ROUTER_LADDER = (
    {"sessions_ratio": 0.80, "replica_queue_delay_us": 50_000.0,
     "replica_pool_ratio": 0.75, "replica_queue_depth": 2.0},
    {"sessions_ratio": 0.88, "replica_queue_delay_us": 100_000.0,
     "replica_pool_ratio": 0.85, "replica_queue_depth": 4.0},
    {"sessions_ratio": 0.94, "replica_queue_delay_us": 150_000.0,
     "replica_pool_ratio": 0.92, "replica_queue_depth": 6.0},
    {"sessions_ratio": 0.98, "replica_queue_delay_us": 200_000.0,
     "replica_pool_ratio": 0.96, "replica_queue_depth": 8.0},
)

# terminal codes that mean THE REPLICA broke, not the generation: the
# session survives and is re-routed (EOVERCROWDED means the
# ROUTER fell behind as a consumer — re-route rather than kill the
# session; tokens already recorded are never re-delivered)
FAILOVER_CODES = frozenset({errors.EFAILEDSOCKET, errors.ELOGOFF,
                            errors.EINTERNAL, errors.ERPCTIMEDOUT,
                            errors.EOVERCROWDED})


class ReplicaHandle:
    """One serving replica behind the router: its address, plus — when
    the replica lives in this process — the local components the
    cluster gradient drives directly (supervisor floor, batcher
    brownout, engine clamp, store evict).  Remote replicas are routing
    targets only; their local ladders still follow the router's shed
    because less traffic is forwarded to them."""

    def __init__(self, addr: str, *, name: Optional[str] = None,
                 supervisor=None, batcher=None, engine=None, store=None,
                 server=None, deployments=None):
        from ..butil.endpoint import str2endpoint
        self.addr = str(addr)
        self.endpoint = str2endpoint(self.addr)
        self.name = name or self.addr
        self.supervisor = supervisor
        self.batcher = batcher
        self.engine = engine
        self.store = store
        self.server = server
        # the replica's ReplicaDeployments, when this process knows
        # which models it serves: the router folds its snapshot into
        # the fleet catalog without an RPC
        self.deployments = deployments

    def pressures(self) -> dict:
        """This replica's local pressure triple (empty when remote)."""
        out = {}
        if self.batcher is not None:
            try:
                out["queue_delay_us"] = float(
                    self.batcher.queue_delay_rec.latency_percentile(0.99))
            except Exception:
                pass
        st = self.store
        if st is None and self.supervisor is not None:
            st = self.supervisor.store
        if st is not None:
            try:
                out["pool_ratio"] = st.pool_ratio()
            except Exception:
                pass
        eng = self.engine
        if eng is None and self.supervisor is not None:
            eng = self.supervisor.engine
        if eng is not None:
            try:
                out["queue_depth"] = eng.queue_depth()
            except Exception:
                pass
        return out


class Session:
    """One durable generation through the router: the prompt, the
    budget, and the emitted-token record that IS the resume cursor.
    Token delivery to the (at most one) attached client is serialized
    by ``delivery_mu`` — replay-on-attach and live appends form one
    ordered stream, so a reconnecting client can neither miss nor
    double-receive a token."""

    __slots__ = ("sid", "prompt", "budget", "emitted", "state",
                 "error_code", "replica", "resumes", "re_decoded_tokens",
                 "replicated_pages", "shipped_pages", "replicate",
                 "created_t",
                 "finished_t", "trace", "mu", "delivery_mu", "_sink",
                 "_sink_done", "attach_epoch", "wal", "_sink_from",
                 "model", "t_first_tok", "t_last_tok")

    def __init__(self, sid: str, prompt: Sequence[int], budget: int,
                 model: str = DEFAULT_MODEL):
        self.sid = sid
        self.prompt = [int(t) for t in prompt]
        self.budget = int(budget)
        # the deployment this session is bound to: routing,
        # buddy placement and WAL adoption are all constrained by it
        self.model = str(model or DEFAULT_MODEL)
        # serving-latency marks for the per-model TTFT/ITL counters
        self.t_first_tok: Optional[float] = None
        self.t_last_tok: Optional[float] = None
        self.emitted: list[int] = []     # the durable cursor record
        self.state = "running"           # running|suspended|finished|failed
        self.error_code = 0
        self.replica: Optional[str] = None
        self.resumes = 0
        self.re_decoded_tokens = 0
        self.replicated_pages = 0        # pushed to the ring buddy
        self.shipped_pages = 0           # full pages already enqueued
        # per-session replication opt-out: short interactive jobs whose
        # recompute is cheaper than shipping their pages set this False
        self.replicate = True
        self.created_t = time.monotonic()
        self.finished_t: Optional[float] = None
        self.trace = rpcz.current_trace_ctx()
        self.mu = InstrumentedLock("router.session")
        # ordering lock for sink delivery: acquired FIRST when both are
        # needed, never held while holding mu is required by others
        self.delivery_mu = InstrumentedLock("router.delivery")
        self._sink: Optional[Callable[[int], None]] = None
        self._sink_done: Optional[Callable] = None
        self.attach_epoch = 0
        # the table's session WAL, or None: every append /
        # terminal is logged write-ahead of client delivery
        self.wal = None
        # delivery suppressed up to this cursor: a client that attached
        # AHEAD of the record (its tokens outran a failed WAL append
        # before the crash) must not re-receive the re-decoded gap
        self._sink_from = 0

    @property
    def cursor(self) -> int:
        return len(self.emitted)

    def append(self, tok: int) -> int:
        """Record one decoded token (the write-ahead: the record is
        always a superset of any client's view) and deliver it to the
        attached client, detaching on a dead sink.  Returns the new
        cursor."""
        with self.delivery_mu:
            with self.mu:
                self.emitted.append(int(tok))
                cur = len(self.emitted)
                sink = self._sink if cur > self._sink_from else None
            if self.wal is not None:
                # WRITE-AHEAD: the durable record reaches disk before
                # the client can see the token, so a successor process
                # replaying the WAL is never behind a presented cursor.
                # append_tok never raises — a failed append parks on
                # the WAL's self-healing pending tail and this session
                # degrades to recompute-on-resume, never a lost token.
                self.wal.append_tok(self.sid, int(tok), cur)
            if sink is not None:
                try:
                    sink(int(tok))
                except Exception:
                    # the client died mid-delivery: detach, keep
                    # decoding — its reconnect replays from its cursor
                    with self.mu:
                        if self._sink is sink:
                            self._sink = None
                            self._sink_done = None
            return cur

    def attach(self, cursor: int, sink: Callable[[int], None],
               sink_done: Optional[Callable] = None) -> int:
        """Attach (or re-attach) a client at ``cursor``: replay every
        recorded token past it, then subscribe for live tokens.  A
        newer attach wins (the previous client is detached).  Returns
        the number of tokens replayed.  If the session already
        finished, the terminal is delivered after the replay.

        A cursor AHEAD of the record is legal while the session can
        still decode: it means the client saw tokens whose
        WAL append failed before a crash.  The session re-decodes the
        gap bit-exact and delivery stays suppressed up to the cursor
        (``_sink_from``), so the client receives exactly the tokens
        past its cursor — recompute-on-resume, never a duplicate.  On
        a TERMINAL session the record can't grow, so a cursor beyond
        it is a client error as before."""
        if cursor < 0:
            raise errors.RpcError(errors.EREQUEST,
                                  f"negative cursor {cursor}")
        with self.delivery_mu:
            with self.mu:
                if cursor > len(self.emitted) and \
                        self.state in ("finished", "failed"):
                    raise errors.RpcError(
                        errors.EREQUEST,
                        f"cursor {cursor} outside the recorded stream "
                        f"({len(self.emitted)} tokens)")
                self.attach_epoch += 1
                self._sink = None        # fence the previous client
                self._sink_done = None
                self._sink_from = cursor
                backlog = self.emitted[cursor:]
                state, err_code = self.state, self.error_code
            for t in backlog:
                sink(t)
            if state in ("finished", "failed"):
                if sink_done is not None:
                    err = None if not err_code else errors.RpcError(
                        err_code, "session terminal (replayed)")
                    sink_done(err)
            else:
                with self.mu:
                    self._sink = sink
                    self._sink_done = sink_done
            return len(backlog)

    def detach(self) -> None:
        with self.delivery_mu:
            with self.mu:
                self._sink = None
                self._sink_done = None

    def finish(self, err) -> bool:
        """Deliver the terminal exactly once.  Returns False when the
        session already reached a terminal state."""
        with self.delivery_mu:
            with self.mu:
                if self.state in ("finished", "failed"):
                    return False
                self.state = "failed" if err is not None else "finished"
                self.error_code = err.code if err is not None else 0
                self.finished_t = time.monotonic()
                sink_done = self._sink_done
                self._sink = None
                self._sink_done = None
            if self.wal is not None:
                # terminal logged ahead of delivery, same discipline
                self.wal.append_fin(self.sid, self.error_code)
            if sink_done is not None:
                try:
                    sink_done(err)
                except Exception:
                    pass
            return True

    def snapshot(self) -> dict:
        with self.mu:
            return {
                "session_id": self.sid,
                "state": self.state,
                "model": self.model,
                "prompt_len": len(self.prompt),
                "budget": self.budget,
                "cursor": len(self.emitted),
                "replica": self.replica,
                "resumes": self.resumes,
                "re_decoded_tokens": self.re_decoded_tokens,
                "replicated_pages": self.replicated_pages,
                "error_code": self.error_code,
            }


class SessionTable:
    """The durable session record store — CALLER-owned, like the KV
    store is to the engine: a router restart builds a new
    :class:`ClusterRouter` over the SAME table and every in-flight
    session resumes instead of recomputing.  Finished sessions are
    kept (bounded ring) so a late reconnect can still replay its
    tail.

    With ``wal=`` a path (or a :class:`~brpc_tpu_torch.serving.session_wal.
    SessionWAL`), every mutation is also logged write-ahead of client
    delivery, and :meth:`recover` rebuilds the table in a FRESH
    PROCESS — the durable half of the control plane."""

    def __init__(self, *, keep_finished: int = 512, wal=None):
        self._mu = InstrumentedLock("router.sessions")
        self._sessions: dict[str, Session] = {}
        self._finished: deque = deque(maxlen=max(keep_finished, 1))
        self.keep_finished = int(keep_finished)
        self.opened_total = 0
        self.replay_stats: Optional[dict] = None
        if wal is not None and not hasattr(wal, "append_tok"):
            from ..serving.session_wal import SessionWAL
            wal = SessionWAL(str(wal))
        self.wal = wal
        if wal is not None:
            wal.snapshot_source = self._wal_snapshot

    @classmethod
    def recover(cls, path, *, keep_finished: int = 512,
                **wal_kwargs) -> "SessionTable":
        """Rebuild a table from a session WAL in a fresh process: every
        recovered non-terminal session comes back SUSPENDED (its drive thread
        died with the old router) at its recorded cursor, terminal ones
        land in the keep-ring so late reconnects still replay.  The
        replayed state is immediately compacted (adoption is the
        natural compaction point) and ``replay_stats`` records what the
        adoption replayed for the /cluster page."""
        from ..serving.session_wal import SessionWAL
        wal = SessionWAL(str(path), **wal_kwargs)
        t = cls(keep_finished=keep_finished, wal=wal)
        recovered, wal.recovered = wal.recovered, {}
        live = finished = 0
        for sid, rec in recovered.items():
            s = Session(sid, rec["prompt"], rec["budget"],
                        rec.get("model") or DEFAULT_MODEL)
            s.emitted = list(rec["emitted"])
            s.state = rec["state"]
            s.error_code = rec["error_code"]
            if s.state == "running":
                s.state = "suspended"
            s.wal = wal
            t._sessions[sid] = s
            if s.state in ("finished", "failed"):
                s.finished_t = time.monotonic()
                t._finished.append(s)
                finished += 1
            else:
                live += 1
        t.opened_total = len(recovered)
        t.replay_stats = dict(wal.replay)
        t.replay_stats.update({"live": live, "finished": finished})
        wal.compact()
        return t

    def _wal_snapshot(self) -> list[dict]:
        """Compaction source: the full current state of every session
        still in the table, as the dicts a ``snap`` record holds.
        Called UNDER the WAL lock (wal._mu -> table._mu -> session.mu
        is the documented order)."""
        with self._mu:
            sessions = list(self._sessions.values())
        out = []
        for s in sessions:
            with s.mu:
                out.append({"sid": s.sid, "prompt": list(s.prompt),
                            "budget": s.budget,
                            "emitted": list(s.emitted),
                            "state": s.state,
                            "error_code": s.error_code,
                            "model": s.model})
        return out

    def new_session(self, prompt: Sequence[int], budget: int,
                    model: str = DEFAULT_MODEL) -> Session:
        sid = uuid.uuid4().hex[:16]
        s = Session(sid, prompt, budget, model)
        s.wal = self.wal
        with self._mu:
            self._sessions[sid] = s
            self.opened_total += 1
        if self.wal is not None:
            # logged after the insert but before any token can flow
            # (the drive thread starts only after open_session returns)
            self.wal.append_open(sid, s.prompt, s.budget, model=s.model)
        return s

    def get(self, sid: str) -> Optional[Session]:
        with self._mu:
            return self._sessions.get(sid)

    def note_finished(self, s: Session) -> None:
        """Move a finished session into the bounded keep-ring (evicting
        the oldest finished record past capacity)."""
        with self._mu:
            if s.sid not in self._sessions:
                return
            if len(self._finished) == self._finished.maxlen:
                old = self._finished[0]
                self._sessions.pop(old.sid, None)
            self._finished.append(s)

    def suspend_running(self) -> int:
        """Mark every running session suspended (router shutdown /
        crash adoption): a later attach restarts its drive thread."""
        n = 0
        with self._mu:
            sessions = list(self._sessions.values())
        for s in sessions:
            with s.mu:
                if s.state == "running":
                    s.state = "suspended"
                    n += 1
        return n

    def counts(self) -> dict:
        with self._mu:
            sessions = list(self._sessions.values())
        out = {"running": 0, "suspended": 0, "finished": 0, "failed": 0}
        for s in sessions:
            out[s.state] = out.get(s.state, 0) + 1
        out["total"] = len(sessions)
        out["opened_total"] = self.opened_total
        return out

    def live_count(self) -> int:
        with self._mu:
            sessions = list(self._sessions.values())
        return sum(1 for s in sessions
                   if s.state in ("running", "suspended"))

    def counts_by_model(self) -> dict:
        """Per-deployment session-state counts (the /cluster catalog
        panel's per-model column)."""
        with self._mu:
            sessions = list(self._sessions.values())
        out: dict[str, dict] = {}
        for s in sessions:
            row = out.setdefault(s.model, {"running": 0, "suspended": 0,
                                           "finished": 0, "failed": 0})
            row[s.state] = row.get(s.state, 0) + 1
        return out

    def snapshot(self, limit: int = 50) -> list[dict]:
        with self._mu:
            sessions = list(self._sessions.values())
        sessions.sort(key=lambda s: s.created_t)
        return [s.snapshot() for s in sessions[-limit:]]

    def close(self) -> None:
        """Close the table's WAL (if any).  The table itself needs no
        teardown — it is plain caller-owned state."""
        if self.wal is not None:
            self.wal.close()


class _ForwardCollector:
    """Stream handler for ONE forward attempt: tokens go straight into
    the session record (which fans them to the attached client), the
    terminal latches here for the drive thread to classify."""

    def __init__(self, router: "ClusterRouter", session: Session):
        self.router = router
        self.session = session
        self.error: Optional[int] = None
        self.prefix_hit = 0
        self.done = threading.Event()
        self._terminal_seen = False

    def on_received_messages(self, stream, messages):
        for m in messages:
            try:
                d = json.loads(m)
            except ValueError:
                continue
            if "token" in d:
                cur = self.session.append(int(d["token"]))
                self.router._on_session_progress(self.session, cur)
            if d.get("done"):
                self._terminal_seen = True
                if d.get("error"):
                    self.error = int(d["error"])
                self.done.set()

    def on_closed(self, stream):
        if not self._terminal_seen and self.error is None:
            # the stream died under the generation (replica kill,
            # socket loss): a truncated stream is a FAILOVER, never a
            # completed generation (an error already latched — e.g.
            # the progress deadline's — is kept)
            self.error = errors.EFAILEDSOCKET
        self.done.set()

    def on_idle_timeout(self, stream):
        pass


class ClusterRouter:
    """The routing service in front of N serving replicas (see module
    docstring).  ``replicas`` is a sequence of addresses or
    :class:`ReplicaHandle`\\ s; pass ``sessions=`` an existing
    :class:`SessionTable` to adopt a previous router's sessions."""

    def __init__(self, replicas: Sequence, *,
                 sessions: Optional[SessionTable] = None,
                 wal=None,
                 limiter=None,
                 max_sessions: int = 256,
                 ladder: Sequence[dict] = DEFAULT_ROUTER_LADDER,
                 hysteresis_ticks: int = 3,
                 check_interval_s: float = 0.05,
                 auto_tick: bool = True,
                 replicate_sessions: bool = False,
                 replication_factor: int = 2,
                 page_tokens: int = 16,
                 chunk_tokens: int = 16,
                 clamp_new_tokens: int = 32,
                 ladder_evict_pages: Optional[int] = None,
                 quarantine_after: int = 3,
                 failure_window_s: float = 60.0,
                 name: str = "router",
                 timeout_ms: int = 10_000,
                 control_timeout_ms: int = 2_000,
                 epoch: Optional[int] = None,
                 progress_timeout_s: float = 30.0,
                 default_model: str = DEFAULT_MODEL,
                 telemetry_collect: bool = True,
                 telemetry_pull_interval_s: float = 0.25):
        from ..policy.load_balancer import PrefixAffinityLB
        from ..rpc.channel import Channel, control_channel
        from ..rpc.combo_channels import SelectiveChannel

        self.name = name
        self.timeout_ms = int(timeout_ms)
        self.control_timeout_ms = int(control_timeout_ms)
        self.progress_timeout_s = float(progress_timeout_s)
        self.chunk_tokens = int(chunk_tokens)
        self.page_tokens = int(page_tokens)
        self.max_sessions = int(max_sessions)
        self.clamp_new_tokens = int(clamp_new_tokens)
        self.ladder_evict_pages = ladder_evict_pages
        self.quarantine_after = int(quarantine_after)
        self.failure_window_s = float(failure_window_s)
        self.replicate_sessions = bool(replicate_sessions)
        # N-way placement: total copies of a prefix on the
        # affinity ring — the owner plus replication_factor-1 buddies
        self.replication_factor = max(1, int(replication_factor))
        self.check_interval_s = float(check_interval_s)
        self.default_model = str(default_model or DEFAULT_MODEL)

        self.replicas: list[ReplicaHandle] = [
            r if isinstance(r, ReplicaHandle) else ReplicaHandle(r)
            for r in replicas]
        if not self.replicas:
            raise ValueError("a router needs at least one replica")
        self._lb = PrefixAffinityLB()
        self._sel = SelectiveChannel(max_retry=len(self.replicas),
                                     lb=self._lb)
        self._by_ep: dict = {}
        # PushTo rides channels of its own that feed no circuit breaker:
        # a page push takes tens of ms, a forward's answer ~1
        self._push_chan_by_ep: dict = {}
        self._ep_by_name: dict = {}      # str(endpoint) / addr -> endpoint
        for h in self.replicas:
            ch = Channel(h.addr, timeout_ms=self.timeout_ms)
            self._sel.add_channel(ch, endpoint=h.endpoint)
            self._by_ep[h.endpoint] = h
            self._push_chan_by_ep[h.endpoint] = control_channel(
                h.addr, self.timeout_ms)
            self._ep_by_name[str(h.endpoint)] = h.endpoint
            self._ep_by_name[h.addr] = h.endpoint

        if sessions is not None:
            self.sessions = sessions
        else:
            self.sessions = SessionTable(wal=wal)
        # adopting a table from a dead router: its running sessions have
        # no drive thread anymore — suspend them so attach restarts it
        self.sessions.suspend_running()

        # membership epoch: every floor push carries it and
        # replicas fence pushes from superseded routers.  A router over
        # a WAL bumps the PERSISTED epoch so a successor process always
        # strictly supersedes the router whose log it adopted.
        if epoch is not None:
            self.epoch = int(epoch)
        elif self.sessions.wal is not None:
            self.epoch = self.sessions.wal.bump_epoch()
        else:
            self.epoch = 1

        if limiter is not None:
            from ..policy.concurrency_limiter import create_limiter
            limiter = create_limiter(limiter)
        self.limiter = limiter

        self._ladder = OverloadLadder(ladder,
                                      hysteresis_ticks=hysteresis_ticks)
        self._applied_level = 0
        self._mu = InstrumentedLock("router.state")
        self._failures: dict = {}        # endpoint -> [monotonic times]
        self._drive_threads: dict[str, threading.Thread] = {}

        # wire-level overload: per-remote-replica floor-push
        # state (epoch/level acked, push/ack times, last error) and the
        # freshest pressure report each SetFloor reply carried back
        self._ctrl_chan_by_ep: dict = {}
        self._remote_floor: dict = {}    # endpoint -> state dict
        self.floor_pushes = 0
        self.floor_push_drops = 0
        self.floor_push_refused = 0

        # ownership directory: prefix fingerprint -> where
        # its pages actually are (owner + buddies that acked a push) —
        # forwarded as the prefix_holders hint so a cache-miss replica
        # can PULL the prefix instead of recomputing.  Keys are MODEL
        # fingerprints, so two models sharing a prompt can
        # never read each other's placement.
        from collections import OrderedDict
        self._placement_dir: "OrderedDict[int, dict]" = OrderedDict()
        self._placement_cap = 256

        # the model plane: fleet catalog (who serves
        # what, in which lifecycle state), the canary version splitter,
        # and the per-(model,version) serving counters
        self.catalog = ModelCatalog()
        self.canary = CanarySplit()
        self.model_metrics = ModelMetrics()
        for h in self.replicas:
            if getattr(h, "deployments", None) is not None:
                self.catalog.note(h.addr, h.deployments.snapshot())

        # fleet telemetry plane: the router-LOCAL half
        # (scoreboard sampling + SLO evaluation) runs every tick, but
        # the per-endpoint _telemetry pulls ride their own slower
        # cadence — a pull ships a full bvar snapshot both sides must
        # JSON-encode/decode under the GIL, and at the 20 Hz overload
        # tick that tax alone breaks the <2% overhead gate while SLO
        # windows are seconds-scale and gain nothing from it
        from ..serving.telemetry import FleetCollector
        self.telemetry_collect = bool(telemetry_collect)
        self.telemetry_pull_interval_s = float(telemetry_pull_interval_s)
        self._last_pull_t = 0.0
        self.collector = FleetCollector(
            name, control_timeout_ms=self.control_timeout_ms)
        self.slo = None
        self._floor_sources: list = []

        safe = re.sub(r"\W", "_", name)
        from ..bvar.variable import exposed_variables
        pre = set(exposed_variables(f"router_{safe}*"))
        self.shed_total = Adder(f"router_{safe}_shed")
        self.forwards = Adder(f"router_{safe}_forwards")
        self.resumes_total = Adder(f"router_{safe}_resumes")
        self.replays_total = Adder(f"router_{safe}_replayed_tokens")
        self.reconnects = Adder(f"router_{safe}_reconnects")
        # mis-routes the model constraint caught (a pick landing on a
        # replica that does not serve the session's model — stale
        # catalog or injected router.model_route): MUST stay 0 in any
        # healthy run (rpc_press --models asserts it)
        self.wrong_model_routes = Adder(f"router_{safe}_wrong_model_routes")
        # per-level gradient action counters — the ordering proof
        self.gradient_fired = {
            a: Adder(f"router_{safe}_{a}") for a in LEVEL_ACTIONS}
        PassiveStatus(lambda: self._ladder.level).expose(
            f"router_{safe}_level")
        self._bvar_names = [n for n in exposed_variables(f"router_{safe}*")
                            if n not in pre]

        # buddy replication worker (resume-over-migration): PushTo jobs
        # coalesce per session, never ride the token path
        self._ship_cv = threading.Condition(
            InstrumentedLock("router.ship"))
        self._ship_q: deque = deque()
        self._ship_pending: set[str] = set()

        self._running = True
        self._threads: list[threading.Thread] = []
        if self.replicate_sessions:
            t = threading.Thread(target=self._ship_loop, daemon=True,
                                 name=f"router-ship-{safe}")
            t.start()
            self._threads.append(t)
        if auto_tick:
            t = threading.Thread(target=self._tick_loop, daemon=True,
                                 name=f"router-ladder-{safe}")
            t.start()
            self._threads.append(t)

        from .. import serving as _serving
        _serving._register_router(self)

    # ---- admission (gradient level 1 lives here) ----

    def retry_after_s(self) -> float:
        """The Retry-After hint attached to a router shed: one full
        de-escalation window — earlier retries would land inside the
        same overload plateau and be shed again."""
        return round(max(0.25, self._ladder.hysteresis_ticks *
                         self.check_interval_s), 3)

    def resolve_model(self, model: Optional[str] = None) -> str:
        """Resolve a request's ``model`` field to one deployment key
       : absent -> the sole deployment (or the default
        model), a bare ``model_id`` with several versions -> the canary
        split over the published version weights.  Unknown models raise
        EREQUEST — the misroute never leaves the front door."""
        cat = self.catalog
        if not model:
            if cat.empty():
                return self.default_model
            sole = cat.sole_key()
            if sole is not None:
                return sole
            model = self.default_model
        model = str(model)
        if cat.empty():
            # no catalog published: a single-model fleet, where only
            # the default model exists
            if model == self.default_model:
                return model
            raise errors.RpcError(
                errors.EREQUEST,
                f"unknown model {model!r}: this router serves only "
                f"{self.default_model!r}")
        keys = cat.resolve(model)
        if not keys:
            raise errors.RpcError(
                errors.EREQUEST,
                f"unknown model {model!r}; deployed: {cat.keys()}")
        if len(keys) == 1:
            return keys[0]
        weights = {k: w for k, w in cat.version_weights(model).items()
                   if k in keys}
        if not weights:
            weights = {k: 1 for k in keys}
        return self.canary.pick(model, weights)

    def open_session(self, prompt: Sequence[int],
                     max_new_tokens: int,
                     model: Optional[str] = None) -> Session:
        """Admit one generation: shed-at-router (ELIMIT with a
        ``retry_after_s`` hint in the error text) before anything
        crosses DCN, else create the durable session and start its
        drive thread."""
        if fault.ENABLED and fault.hit(fault.ROUTER_ADMIT,
                                       name=self.name) is not None:
            raise errors.RpcError(errors.EINTERNAL,
                                  "injected router admit failure")
        model = self.resolve_model(model)
        live = self.sessions.live_count()
        shed_text = None
        if not self._running:
            raise errors.RpcError(errors.ELOGOFF, "router closed")
        if self._ladder.level >= 1:
            shed_text = (f"overload gradient level {self._ladder.level}: "
                         f"shed at router")
        elif self.limiter is not None and \
                not self.limiter.on_requested(live + 1):
            shed_text = "router concurrency limiter rejected the session"
        elif live + 1 > self.max_sessions:
            shed_text = (f"session capacity {self.max_sessions} reached")
        if shed_text is not None:
            self.shed_total.add(1)
            self.gradient_fired["shed_at_router"].add(1)
            self.model_metrics.note_shed(model)
            raise errors.RpcError(
                errors.ELIMIT,
                f"{shed_text}; retry_after_s={self.retry_after_s()}")
        s = self.sessions.new_session(prompt, max_new_tokens,
                                      model=model)
        self.model_metrics.note_open(model)
        self._start_drive(s)
        return s

    def attach(self, sid: str, cursor: int,
               sink: Callable[[int], None],
               sink_done: Optional[Callable] = None) -> dict:
        """Client (re)connect: replay the recorded tokens past
        ``cursor``, subscribe for live ones, and — when the session was
        suspended (router restart / dead drive thread) — restart it.
        Returns ``{"replayed": n, "cursor": new_cursor}``."""
        if not self._running:
            # a closed router can no longer drive a suspended session:
            # tell the client now (reconnect to the successor) instead
            # of replaying a backlog that never reaches a terminal
            raise errors.RpcError(errors.ELOGOFF, "router closed")
        if fault.ENABLED and fault.hit(fault.ROUTER_RESUME, sid=sid) is not None:
            raise errors.RpcError(errors.EINTERNAL,
                                  "injected router resume failure")
        s = self.sessions.get(sid)
        if s is None:
            raise errors.RpcError(errors.EREQUEST,
                                  f"unknown session {sid!r}")
        replayed = s.attach(cursor, sink, sink_done)
        if replayed:
            self.replays_total.add(replayed)
        self.reconnects.add(1)
        restart = False
        with s.mu:
            if s.state == "suspended":
                s.state = "running"
                restart = True
        if restart:
            self._start_drive(s)
        return {"replayed": replayed, "cursor": cursor + replayed}

    # ---- the session's drive thread (forward + failover) ----

    def _start_drive(self, s: Session) -> None:
        t = threading.Thread(target=self._drive, args=(s,), daemon=True,
                             name=f"router-session-{s.sid[:8]}")
        with self._mu:
            self._drive_threads[s.sid] = t
        t.start()

    def _fp_for(self, model: str, prompt: Sequence[int]) -> int:
        """The session's ring key: the ``(model, prefix)`` fingerprint,
        with the router's default model mapping to the plain prefix
        fingerprint (a single-model fleet routes as a catalog-less one)."""
        m = None if model == self.default_model else model
        return model_fingerprint(m, prompt, self.chunk_tokens)

    def _allowed_eps(self, model: str) -> Optional[set]:
        """Endpoints serving ``model`` for NEW placements (warm or
        loading; draining replicas only finish what they hold), or
        ``None`` when no catalog is published — the unconstrained
        catalog-less fleet."""
        cat = self.catalog
        if cat.empty():
            return None
        eps = set()
        for addr in cat.replicas_for(model, for_new=True):
            ep = self._ep_by_name.get(addr)
            if ep is not None:
                eps.add(ep)
        return eps

    def _drive(self, s: Session) -> None:
        from ..rpc.controller import Controller
        from ..rpc.stream import stream_create
        fp = self._fp_for(s.model, s.prompt)
        excluded: set = set()
        attempts = 0
        max_attempts = 3 * len(self.replicas) + 3
        # a session with recorded tokens at drive entry is a RESUME
        # (router restart / WAL adoption): its first forward re-sends
        # prompt+emitted and must account re-decoded tokens like any
        # mid-drive failover would
        first_attempt = s.cursor == 0
        try:
            while self._running:
                with s.mu:
                    if s.state != "running":
                        return
                    remaining = s.budget - len(s.emitted)
                    resume_prompt = s.prompt + s.emitted
                if remaining <= 0:
                    self._finish_session(s, None)
                    return
                attempts += 1
                if attempts > max_attempts:
                    self._finish_session(s, errors.RpcError(
                        errors.EINTERNAL,
                        f"router gave up after {attempts - 1} forward "
                        f"attempts"))
                    return
                if attempts > 1:
                    # bounded backoff between attempts: a refusal storm
                    # must not burn the whole attempt budget before
                    # health marking / breaker recovery can land
                    time.sleep(min(0.25, 0.01 * (attempts - 1)))
                # the model constraint: the pick may only
                # land on a replica the catalog says serves s.model —
                # re-read each attempt, a deploy/drain can land mid-
                # session and the failover must honor the new state
                allowed = self._allowed_eps(s.model)
                if allowed is not None and not allowed:
                    self._finish_session(s, errors.RpcError(
                        errors.ENODATA,
                        f"no replica serves model {s.model!r}"))
                    return
                constraint = (set(self._by_ep) - allowed
                              if allowed is not None else set())
                picked = self._sel.pick(exclude=excluded | constraint,
                                        request_code=fp)
                if picked is not None and allowed is not None \
                        and picked[2] not in allowed:
                    # the ring's last-resort fallback handed back an
                    # excluded endpoint: treat as unroutable this round
                    picked = None
                if picked is None and excluded:
                    # everything healthy was tried this round: start a
                    # fresh round (a probe may have revived someone)
                    excluded = set()
                    picked = self._sel.pick(exclude=constraint,
                                            request_code=fp)
                    if picked is not None and allowed is not None \
                            and picked[2] not in allowed:
                        picked = None
                if picked is None:
                    self._finish_session(s, errors.RpcError(
                        errors.ENODATA,
                        f"no routable replica serves model {s.model!r}"
                        if allowed is not None
                        else "no routable replica"))
                    return
                _i, chan, ep = picked
                if fault.ENABLED and fault.hit(
                        fault.ROUTER_MODEL_ROUTE, model=s.model,
                        replica=str(ep)) is not None:
                    # injected catalog staleness: the pick is treated
                    # as a mis-route — counted (the invariant press
                    # asserts on) and re-routed, never forwarded
                    self.wrong_model_routes.add(1)
                    excluded.add(ep)
                    first_attempt = False
                    continue
                if allowed is not None and ep not in allowed:
                    # defense in depth: a stale catalog let a non-
                    # serving replica through — count and re-route
                    self.wrong_model_routes.add(1)
                    excluded.add(ep)
                    first_attempt = False
                    continue
                if not first_attempt:
                    with s.mu:
                        s.resumes += 1
                    self.resumes_total.add(1)
                if fault.ENABLED and fault.hit(
                        fault.ROUTER_FORWARD, replica=str(ep)) is not None:
                    self._note_replica_failure(ep, errors.EINTERNAL)
                    excluded.add(ep)
                    first_attempt = False
                    continue
                col = _ForwardCollector(self, s)
                cntl = Controller(timeout_ms=self.timeout_ms)
                stream = stream_create(cntl, col)
                t0 = time.monotonic()
                fwd = {"prompt": resume_prompt,
                       "max_new_tokens": remaining}
                if not self.catalog.empty():
                    # name the deployment so a multi-model replica
                    # resolves the right engine (a single-model fleet
                    # keeps the catalog-less wire shape)
                    fwd["model"] = s.model
                holders = self._holders_for(fp, exclude_addr=str(ep))
                if holders:
                    # pull-based prefix fetch: tell the
                    # target where this prefix's pages already are so a
                    # cache miss warms itself from an owner over the
                    # migrator instead of re-prefilling
                    fwd["prefix_holders"] = holders
                try:
                    resp = chan.call_sync(
                        "Serving", "Generate", fwd,
                        serializer="json", cntl=cntl)
                except errors.RpcError as e:
                    # the forward RPC itself failed (replica server
                    # gone): channel layer already fed the breaker.
                    # The never-bound stream must close here or it
                    # leaks in the StreamRegistry forever (no socket
                    # failure can ever reap it)
                    try:
                        stream.close()
                    except Exception:
                        pass
                    self._sel.feedback(ep, e.code, breaker=False)
                    self._note_replica_failure(ep, e.code)
                    excluded.add(ep)
                    first_attempt = False
                    continue
                self.forwards.add(1)
                buddy_addr = self._by_ep.get(ep)
                self._note_placement(fp, owner=(
                    buddy_addr.addr if buddy_addr is not None
                    else str(ep)))
                hit = int((resp or {}).get("prefix_hit", 0))
                with s.mu:
                    s.replica = str(ep)
                    if not first_attempt:
                        # what this failover actually re-decodes: the
                        # resume prompt minus what the new replica's
                        # cache already held (committed prefix ridden
                        # via prefill-skip / page migration)
                        s.re_decoded_tokens += max(
                            0, len(resume_prompt) - hit)
                # wait out the attempt; wake periodically so a closing
                # router suspends instead of blocking forever, and
                # watch a PROGRESS deadline — a replica that accepted
                # the forward but neither emits nor closes (server
                # alive, engine wedged) must read as a failover, not
                # hang the session until router close
                last_cursor = s.cursor
                last_progress = time.monotonic()
                while self._running:
                    if col.done.wait(0.1):
                        break
                    cur = s.cursor
                    if cur != last_cursor:
                        last_cursor = cur
                        last_progress = time.monotonic()
                    elif (time.monotonic() - last_progress
                          > self.progress_timeout_s):
                        col.error = errors.ERPCTIMEDOUT
                        try:
                            stream.close()
                        except Exception:
                            pass
                        break
                    with s.mu:
                        if s.state != "running":
                            break
                with s.mu:
                    still_running = s.state == "running"
                if not self._running or not still_running:
                    try:
                        stream.close()
                    except Exception:
                        pass
                    return
                latency_us = int((time.monotonic() - t0) * 1e6)
                if col.error is None:
                    self._sel.feedback(ep, 0, latency_us, breaker=False)
                    self._finish_session(s, None)
                    return
                if col.error in FAILOVER_CODES:
                    # replica failure mid-stream: quarantine evidence,
                    # re-route, resume after the recorded cursor
                    self._sel.feedback(ep, col.error, latency_us,
                                       breaker=True)
                    self._note_replica_failure(ep, col.error)
                    excluded = {ep}
                    first_attempt = False
                    continue
                # the generation's own terminal error: definite
                self._finish_session(s, errors.RpcError(
                    col.error, "replica terminal error"))
                return
            # router closing: suspend (a successor adopts the table)
            with s.mu:
                if s.state == "running":
                    s.state = "suspended"
        finally:
            with self._mu:
                self._drive_threads.pop(s.sid, None)

    def cancel_session(self, s: Session, err=None) -> None:
        """Abort a session no client can ever reach (e.g. its Generate
        attach failed after admission): deliver the terminal, release
        the limiter slot, and let the drive thread notice the state flip and
        stop forwarding — without this, the orphan decodes its whole
        budget for nobody while counting against ``max_sessions``."""
        if err is None:
            err = errors.RpcError(errors.ELOGOFF, "session cancelled")
        self._finish_session(s, err)

    def _finish_session(self, s: Session, err) -> None:
        if s.finish(err):
            code = err.code if err is not None else 0
            if self.limiter is not None:
                dur_us = int((time.monotonic() - s.created_t) * 1e6)
                self.limiter.on_responded(code, dur_us)
            self.sessions.note_finished(s)

    def _note_replica_failure(self, ep, code: int) -> None:
        """Forward-failure evidence: feeds the breaker's isolation
        counter and — past ``quarantine_after`` failures inside the
        window — marks the endpoint broken, exactly the supervisor's
        flapping-replica discipline.  The prefix-affinity ring then
        walks past it, remapping only ITS share of prefixes."""
        now = time.monotonic()
        with self._mu:
            times = self._failures.setdefault(ep, [])
            times.append(now)
            times[:] = [t for t in times
                        if t > now - self.failure_window_s]
            n = len(times)
        try:
            from ..policy.circuit_breaker import global_breaker
            breaker = global_breaker()
            breaker.on_socket_failed(ep)
            if n >= self.quarantine_after:
                breaker.mark_as_broken(ep)
        except Exception:
            import logging
            logging.getLogger(__name__).exception(
                "router replica-failure report failed")

    # ---- buddy replication (resume-over-migration) ----

    def _on_session_progress(self, s: Session, cursor: int) -> None:
        # per-(model,version) latency counters: one writer
        # per session (the collector thread), so the marks need no lock
        now = time.monotonic()
        if s.t_first_tok is None:
            s.t_first_tok = now
            self.model_metrics.note_ttft(s.model, now - s.created_t)
        elif s.t_last_tok is not None:
            self.model_metrics.note_itl(s.model, now - s.t_last_tok)
        s.t_last_tok = now
        if not self.replicate_sessions or not s.replicate:
            return
        with s.mu:
            full = (len(s.prompt) + cursor) // self.page_tokens
            ship = full > s.shipped_pages
            if ship:
                s.shipped_pages = full
        if ship:
            with self._ship_cv:
                if s.sid not in self._ship_pending:
                    self._ship_pending.add(s.sid)
                    self._ship_q.append(s.sid)
                    self._ship_cv.notify()

    def _ship_loop(self) -> None:
        from ..butil import stagetag
        while True:
            with self._ship_cv:
                while self._running and not self._ship_q:
                    self._ship_cv.wait(0.25)
                if not self._running:
                    return
                sid = self._ship_q.popleft()
                self._ship_pending.discard(sid)
            with stagetag.stage("migrate"):
                try:
                    self._ship_one(sid)
                except Exception:
                    import logging
                    logging.getLogger(__name__).info(
                        "session buddy replication failed", exc_info=True)

    def _ship_one(self, sid: str) -> None:
        """Ask the session's serving replica to push its committed
        full pages to its ring BUDDIES — the ``replication_factor - 1``
        ring successors a failover of this prefix would land on — over
        the ``_kvmig`` PushTo RPC, and record the resulting N-way
        placement in the ownership directory.  A failing push degrades
        the future resume to recompute; it never touches the token
        path."""
        s = self.sessions.get(sid)
        if s is None:
            return
        with s.mu:
            if s.state != "running" or s.replica is None:
                return
            toks = s.prompt + s.emitted
            cur_addr = s.replica
        cur_ep = self._ep_by_name.get(cur_addr)
        fp = self._fp_for(s.model, s.prompt)
        # buddy placement constrained to SAME-MODEL holders:
        # a failover can only land on a replica serving s.model, so
        # only those are worth warming
        ex = {cur_ep} if cur_ep is not None else set()
        allowed = self._allowed_eps(s.model)
        if allowed is not None:
            ex |= set(self._by_ep) - allowed
        buddies = self._lb.placement(
            fp, self.replication_factor, exclude=ex or None)
        if allowed is not None:
            buddies = [b for b in buddies if b in allowed]
        buddies = [b for b in buddies if str(b) != cur_addr]
        buddies = buddies[:max(0, self.replication_factor - 1)]
        if not buddies:
            return
        picked = self._push_chan_by_ep.get(cur_ep)
        if picked is None:
            return
        full = len(toks) // self.page_tokens * self.page_tokens
        if not full:
            return
        best = 0
        acked: list[str] = []
        push = {"tokens": toks[:full], "dest": None}
        if not self.catalog.empty():
            # same-model fetch constraint: a model-tagged
            # _kvmig endpoint refuses pushes for another model, so a
            # stale placement can never splice B-pages into an A-store
            push["model"] = s.model
        for buddy in buddies:
            buddy_h = self._by_ep.get(buddy)
            dest = buddy_h.addr if buddy_h is not None else str(buddy)
            push["dest"] = dest
            try:
                out = picked.call_sync(
                    "_kvmig", "PushTo", dict(push),
                    serializer="json", response_serializer="json")
            except errors.RpcError:
                # this buddy degrades to recompute; the others still
                # get their copy
                continue
            pages = int((out or {}).get("migrated_pages", 0))
            if pages:
                best = max(best, pages)
                acked.append(dest)
        self._note_placement(fp, owner=cur_addr, buddies=acked)
        if best:
            with s.mu:
                s.replicated_pages = max(s.replicated_pages, best)

    # ---- the ownership directory (N-way placement) ----

    def _note_placement(self, fp: int, *, owner: Optional[str] = None,
                        buddies: Optional[Sequence[str]] = None) -> None:
        with self._mu:
            rec = self._placement_dir.get(fp)
            if rec is None:
                rec = {"owner": None, "buddies": []}
                self._placement_dir[fp] = rec
                while len(self._placement_dir) > self._placement_cap:
                    self._placement_dir.popitem(last=False)
            else:
                self._placement_dir.move_to_end(fp)
            if owner is not None:
                rec["owner"] = str(owner)
            for b in buddies or ():
                if b not in rec["buddies"]:
                    rec["buddies"].append(str(b))

    def _holders_for(self, fp: int,
                     exclude_addr: Optional[str] = None) -> list[str]:
        """Everywhere this prefix's pages are known to be (owner first,
        then acked buddies), minus the forward target itself."""
        with self._mu:
            rec = self._placement_dir.get(fp)
            if rec is None:
                return []
            out = []
            if rec["owner"]:
                out.append(rec["owner"])
            out.extend(b for b in rec["buddies"] if b not in out)
        ex = str(exclude_addr) if exclude_addr is not None else None
        ex_ep = self._ep_by_name.get(ex) if ex is not None else None
        drop = {ex} if ex else set()
        if ex_ep is not None:
            drop.add(str(ex_ep))
            h = self._by_ep.get(ex_ep)
            if h is not None:
                drop.add(h.addr)
        return [a for a in out if a not in drop]

    def placements(self, limit: int = 32) -> list[dict]:
        """The N-way buddy placement table for the /cluster page."""
        with self._mu:
            items = list(self._placement_dir.items())[-limit:]
        return [{"fingerprint": f"{fp:016x}", "owner": rec["owner"],
                 "buddies": list(rec["buddies"])}
                for fp, rec in items]

    # ---- the cluster overload gradient ----

    def _tick_loop(self) -> None:
        while self._running:
            time.sleep(self.check_interval_s)
            if not self._running:
                return
            try:
                self._tick()
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "router ladder tick failed")

    def _pressures(self) -> dict:
        cap = self.max_sessions
        if self.limiter is not None:
            lim = self.limiter.max_concurrency()
            if lim > 0:
                cap = min(cap, lim)
        out = {"sessions_ratio": self.sessions.live_count() / max(1, cap)}
        qd = pool = depth = 0.0
        for h in self.replicas:
            p = h.pressures()
            if not p and self._is_remote(h):
                # remote replica: read the pressure report its last
                # SetFloor ack carried back (wire-level overload) —
                # a remote-only fleet feeds the gradient too
                st = self._remote_floor.get(h.endpoint)
                if st is not None:
                    p = st.get("pressures") or {}
            qd = max(qd, p.get("queue_delay_us", 0.0))
            pool = max(pool, p.get("pool_ratio", 0.0))
            depth = max(depth, p.get("queue_depth", 0.0))
        out["replica_queue_delay_us"] = qd
        out["replica_pool_ratio"] = pool
        out["replica_queue_depth"] = depth
        return out

    def _tick(self) -> int:
        # advisory floor sources: the ladder's floor is the
        # max over registered sources — a held MINIMUM level, never an
        # escalation; the pressure gradient stays in charge above it
        floor = 0
        for fn in self._floor_sources:
            try:
                floor = max(floor, int(fn()))
            except Exception:
                pass
        self._ladder.floor = min(floor, self._ladder.num_levels)
        lvl = self._ladder.update(self._pressures())
        self._apply_level(lvl)
        self._push_floor(lvl)
        # refresh the catalog from in-process replicas (remote ones
        # publish via their SetFloor ack in _push_floor)
        for h in self.replicas:
            if getattr(h, "deployments", None) is not None:
                self.catalog.note(h.addr, h.deployments.snapshot())
        if self.telemetry_collect:
            self._collect_telemetry()
        return lvl

    def _collect_telemetry(self) -> None:
        """One fleet-telemetry pass: sample the router-local
        per-(model, version) scoreboard into the fleet series, pull each
        endpoint's ``_telemetry`` increment over the control channel the
        SetFloor push already holds open (at most once per
        ``telemetry_pull_interval_s``), then run the SLO engine over
        the refreshed series."""
        from ..policy.health_check import is_broken
        c = self.collector
        c.sample_models(self.model_metrics)
        now = time.monotonic()
        if now - self._last_pull_t >= self.telemetry_pull_interval_s:
            self._last_pull_t = now
            for h in self.replicas:
                if is_broken(h.endpoint):
                    # a quarantined replica is TOMBSTONED, never
                    # pulled: pulling a dead endpoint would stall the
                    # tick thread for the control timeout every pass,
                    # and the series must show the gap, not silently
                    # average over it
                    c.note_dead(h.addr)
                    continue
                c.pull(h.addr, self._ctrl_channel(h))
        if self.slo is not None:
            try:
                self.slo.tick(c, self)
            except Exception:
                import logging
                logging.getLogger(__name__).exception("slo tick failed")

    def add_floor_source(self, fn) -> None:
        """Register an advisory floor source: a zero-arg callable whose
        value (clamped to the ladder height) joins the per-tick max
        holding the ladder's floor."""
        self._floor_sources.append(fn)

    def attach_slo(self, engine) -> None:
        """Attach an SLO burn-rate engine: any object with
        ``tick(collector, router)``, ``floor()`` and ``snapshot()``.  It
        is ticked after every collection pass (its decisions may call
        :meth:`deploy_model`, epoch-fenced like the floor pushes), and
        its ``floor()`` becomes an advisory floor source."""
        self.slo = engine
        self.add_floor_source(engine.floor)

    def trace_fanout(self, trace_id: int) -> list:
        """Every collected span of one trace across the FLEET: local
        and fleet-store spans plus live ``_telemetry`` Trace queries
        to each replica and to every peer address the merged client
        spans name (the hop that reaches a PS shard this router never
        talks to directly)."""
        return self.collector.fan_out_trace(
            int(trace_id), addrs=[h.addr for h in self.replicas])

    def fleet_snapshot(self, points: int = 32) -> dict:
        """The /fleet console page's data for this router: collector
        state + tombstones, the windowed series rings, the per-model
        scoreboard, canary ramp state and the SLO decision trail."""
        return {
            "collector": self.collector.stats(),
            "series": self.collector.series_snapshot(points),
            "models": self.model_metrics.snapshot(),
            "canary": self.canary.snapshot(),
            "catalog": self.catalog.snapshot(),
            "slo": self.slo.snapshot() if self.slo is not None else None,
            "ladder": self._ladder.stats(),
        }

    def _apply_level(self, lvl: int) -> None:
        from ..serving.ladder import apply_level_to_components
        prev = self._applied_level
        if lvl > prev:
            # count each action the FIRST time the ramp reaches it —
            # the gradient-ordering proof (shed counted at the actual
            # refusals in open_session; the flag here marks the level
            # transition itself for levels without a local component)
            for step in range(prev + 1, lvl + 1):
                if 2 <= step <= len(LEVEL_ACTIONS):
                    self.gradient_fired[LEVEL_ACTIONS[step - 1]].add(1)
        self._applied_level = lvl
        for h in self.replicas:
            apply_level_to_components(
                lvl, supervisor=h.supervisor, batcher=h.batcher,
                engine=h.engine, store=h.store,
                clamp_new_tokens=self.clamp_new_tokens,
                evict_pages=self.ladder_evict_pages)

    # ---- wire-level overload (remote floor push) ----

    @staticmethod
    def _is_remote(h: ReplicaHandle) -> bool:
        return all(x is None for x in
                   (h.supervisor, h.batcher, h.engine, h.store))

    def _ctrl_channel(self, h: ReplicaHandle):
        ch = self._ctrl_chan_by_ep.get(h.endpoint)
        if ch is None:
            from ..rpc.channel import control_channel
            # a dedicated short-timeout channel: a dead replica must
            # cost the tick loop control_timeout_ms, not the data
            # plane's full forward timeout
            ch = control_channel(h.addr, self.control_timeout_ms)
            self._ctrl_chan_by_ep[h.endpoint] = ch
        return ch

    def _push_floor(self, lvl: int) -> None:
        """Push the cluster gradient level (plus this router's
        membership epoch) to every REMOTE replica's ``_cluster``
        control service, and collect its pressure report from the
        reply.  A dropped push (injected ``cluster.floor_push``, dead
        replica) is simply re-pushed next tick; a replica that already
        saw a HIGHER epoch refuses — this router is superseded."""
        for h in self.replicas:
            if not self._is_remote(h):
                continue
            st = self._remote_floor.setdefault(h.endpoint, {
                "addr": h.addr, "epoch": self.epoch, "level": None,
                "acked_level": None, "last_push_t": None,
                "last_ack_t": None, "pressures": {}, "error": None,
                "unsupported": False, "drops": 0, "refused": 0})
            if st["unsupported"]:
                continue
            if fault.ENABLED and fault.hit(
                    fault.CLUSTER_FLOOR_PUSH, replica=h.addr) is not None:
                # the push is LOST on the wire: no state change at the
                # replica; the next tick re-pushes
                st["drops"] += 1
                self.floor_push_drops += 1
                continue
            st["last_push_t"] = time.monotonic()
            st["level"] = lvl
            st["epoch"] = self.epoch
            self.floor_pushes += 1
            try:
                resp = self._ctrl_channel(h).call_sync(
                    "_cluster", "SetFloor",
                    {"epoch": int(self.epoch), "level": int(lvl),
                     "router": self.name},
                    serializer="tensorframe",
                    response_serializer="tensorframe")
            except errors.RpcError as e:
                if e.code == errors.ENOMETHOD:
                    # replica without the control service: stop asking
                    st["unsupported"] = True
                elif "stale epoch" in (e.text or ""):
                    st["refused"] += 1
                    self.floor_push_refused += 1
                st["error"] = e.code
                continue
            st["error"] = None
            st["last_ack_t"] = time.monotonic()
            st["acked_level"] = int((resp or {}).get("level", lvl))
            st["pressures"] = {
                k: float(resp[k]) for k in
                ("queue_delay_us", "pool_ratio", "queue_depth")
                if resp and k in resp}
            # the ack doubles as the replica's catalog publication
            #: fold its deployments into the fleet view
            rows = parse_deployments((resp or {}).get("deployments"))
            if rows is not None:
                self.catalog.note(h.addr, rows)

    def deploy_model(self, model: str, *, op: str = "deploy",
                     addrs: Optional[Sequence[str]] = None,
                     weight: int = 1,
                     state: Optional[str] = None) -> dict:
        """Fleet-wide lifecycle push: ``deploy`` /
        ``undeploy`` / ``drain`` one model on the named replicas (all
        by default), carrying this router's membership epoch so a
        superseded router's lifecycle pushes are fenced exactly like
        its floor pushes.  In-process replicas are driven directly;
        remote ones over the ``_cluster`` service.  Returns per-replica
        outcomes (``"ok"`` or the error text) — partial failure is the
        caller's to retry, the push is idempotent."""
        from ..serving.modelplane import cluster_deploy
        targets = []
        want = set(str(a) for a in addrs) if addrs is not None else None
        for h in self.replicas:
            if want is None or h.addr in want \
                    or str(h.endpoint) in (want or ()):
                targets.append(h)
        out = {}
        for h in targets:
            deps = getattr(h, "deployments", None)
            if deps is not None:
                if op == "deploy":
                    deps.deploy(model, weight=weight,
                                state=state or "loading")
                elif op == "undeploy":
                    deps.undeploy(model)
                elif op == "drain":
                    deps.drain(model)
                else:
                    raise ValueError(f"unknown deploy op {op!r}")
                self.catalog.note(h.addr, deps.snapshot())
                out[h.addr] = "ok"
                continue
            try:
                cluster_deploy(h.addr, epoch=self.epoch, model=model,
                               op=op, weight=weight, state=state,
                               timeout_ms=self.control_timeout_ms)
                out[h.addr] = "ok"
            except errors.RpcError as e:
                out[h.addr] = f"E{e.code}: {e.text}"
        return out

    def remote_floor_table(self) -> list[dict]:
        """Remote-floor propagation per replica for /cluster: epoch,
        last push, ack age, acked level."""
        now = time.monotonic()
        out = []
        for ep, st in list(self._remote_floor.items()):
            out.append({
                "addr": st["addr"], "epoch": st["epoch"],
                "pushed_level": st["level"],
                "acked_level": st["acked_level"],
                "push_age_s": (round(now - st["last_push_t"], 3)
                               if st["last_push_t"] else None),
                "ack_age_s": (round(now - st["last_ack_t"], 3)
                              if st["last_ack_t"] else None),
                "drops": st["drops"], "refused": st["refused"],
                "error": st["error"],
                "unsupported": st["unsupported"],
            })
        return out

    @property
    def level(self) -> int:
        return self._ladder.level

    # ---- lifecycle / introspection ----

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop routing.  Running sessions are SUSPENDED (their records
        stay in the caller-owned SessionTable for the next router),
        replica-side gradient effects are undone, and this router's
        bvars are hidden."""
        self._running = False
        with self._ship_cv:
            self._ship_cv.notify_all()
        deadline = time.monotonic() + timeout_s
        with self._mu:
            drives = list(self._drive_threads.values())
        for t in self._threads + drives:
            t.join(max(0.0, deadline - time.monotonic()))
        self.sessions.suspend_running()
        # undo gradient side effects on caller-owned components
        self._ladder.reset()
        self._apply_level(0)
        for h in self.replicas:
            if h.supervisor is not None:
                h.supervisor.set_level_floor(0)
        from ..bvar.variable import find_exposed
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()
        self.collector.close()

    def replica_table(self) -> list[dict]:
        from ..policy.circuit_breaker import global_breaker
        from ..policy.health_check import is_broken
        breaker = global_breaker()
        with self._mu:
            fail_counts = {ep: len(ts) for ep, ts in self._failures.items()}
        out = []
        for h in self.replicas:
            row = {
                "name": h.name,
                "addr": h.addr,
                "healthy": not is_broken(h.endpoint),
                "quarantined": is_broken(h.endpoint),
                "breaker_isolations": breaker.isolation_count(h.endpoint),
                "recent_failures": fail_counts.get(h.endpoint, 0),
                "local": any(x is not None for x in
                             (h.supervisor, h.batcher, h.engine, h.store)),
            }
            if h.supervisor is not None:
                row["ladder_level"] = h.supervisor.level
                row["state"] = h.supervisor.state
            out.append(row)
        return out

    def stats(self) -> dict:
        wal = self.sessions.wal
        return {
            "name": self.name,
            "epoch": self.epoch,
            "replicas": self.replica_table(),
            "sessions": self.sessions.counts(),
            "sessions_by_model": self.sessions.counts_by_model(),
            "session_rows": self.sessions.snapshot(limit=20),
            "ladder": self._ladder.stats(),
            "level_actions": list(LEVEL_ACTIONS),
            "gradient_fired": {a: c.get_value()
                               for a, c in self.gradient_fired.items()},
            "shed": self.shed_total.get_value(),
            "forwards": self.forwards.get_value(),
            "resumes": self.resumes_total.get_value(),
            "reconnects": self.reconnects.get_value(),
            "replayed_tokens": self.replays_total.get_value(),
            "retry_after_s": self.retry_after_s(),
            "replicate_sessions": self.replicate_sessions,
            "replication_factor": self.replication_factor,
            "placements": self.placements(),
            "default_model": self.default_model,
            "catalog": self.catalog.snapshot(),
            "models": self.model_metrics.snapshot(),
            "canary": self.canary.snapshot(),
            "wrong_model_routes": self.wrong_model_routes.get_value(),
            "telemetry": self.collector.stats(),
            "slo": self.slo.snapshot() if self.slo is not None else None,
            "remote_floor": self.remote_floor_table(),
            "floor_pushes": self.floor_pushes,
            "floor_push_drops": self.floor_push_drops,
            "floor_push_refused": self.floor_push_refused,
            "wal": wal.stats() if wal is not None else None,
            "wal_replay": self.sessions.replay_stats,
        }


class RouterService(Service):
    """RPC surface of a ClusterRouter: streaming ``Generate`` (fresh
    session) and ``Resume`` (reconnect with ``session_id`` + cursor).
    Token messages carry the cursor — ``{"token": t, "cursor": i}`` —
    so clients can checkpoint without counting."""

    NAME = ROUTER_SERVICE

    def __init__(self, router: ClusterRouter):
        self._router = router

    def _attach_stream(self, cntl, sess_or_sid, cursor: int):
        router = self._router
        stream = cntl.accept_stream()
        state = {"cursor": cursor}

        def emit(tok: int) -> None:
            state["cursor"] += 1
            stream.write(json.dumps(
                {"token": int(tok),
                 "cursor": state["cursor"]}).encode(), timeout_s=2.0)

        def on_done(err) -> None:
            msg = {"done": True, "session_id": sid}
            if err is not None:
                msg["error"] = err.code
                msg["error_text"] = err.text
            try:
                stream.write(json.dumps(msg).encode(), timeout_s=2.0)
            except errors.RpcError:
                pass
            stream.close()

        if isinstance(sess_or_sid, Session):
            sid = sess_or_sid.sid
            info = router.attach(sid, cursor, emit, on_done)
        else:
            sid = str(sess_or_sid)
            info = router.attach(sid, cursor, emit, on_done)
        return sid, info

    @method(request="json", response="json")
    def Generate(self, cntl, req):
        req = req or {}
        prompt = req.get("prompt") or [0]
        max_new = int(req.get("max_new_tokens", 16))
        model = req.get("model") or None
        try:
            sess = self._router.open_session(prompt, max_new, model=model)
        except errors.RpcError as e:
            cntl.set_failed(e.code, e.text)    # ELIMIT retry_after_s=<hint>
            return None                        # or EREQUEST unknown model
        try:
            sid, _ = self._attach_stream(cntl, sess, 0)
        except errors.RpcError as e:
            # the client never learned the session_id: an admitted-but-
            # unattachable session would decode its whole budget for
            # nobody — cancel it
            self._router.cancel_session(sess, e)
            cntl.set_failed(e.code, e.text)
            return None
        return {"accepted": True, "session_id": sid,
                "model": sess.model}

    @method(request="json", response="json")
    def Resume(self, cntl, req):
        req = req or {}
        sid = req.get("session_id")
        if not sid:
            cntl.set_failed(errors.EREQUEST, 'missing "session_id"')
            return None
        cursor = int(req.get("cursor", 0))
        try:
            sid, info = self._attach_stream(cntl, str(sid), cursor)
        except errors.RpcError as e:
            cntl.set_failed(e.code, e.text)
            return None
        return {"accepted": True, "session_id": sid, **info}

    @method(request="json", response="json")
    def Stats(self, cntl, req):
        return self._router.stats()


def register_router(server, router: ClusterRouter) -> RouterService:
    """Expose `router` on `server` (call before ``server.start()``).
    The router process joins the fleet telemetry plane too:
    its ``_telemetry`` service is what lets ANOTHER router (or an
    operator's one-shot pull) read this one's bvars and spans."""
    from ..serving.telemetry import (TELEMETRY_SERVICE,
                                            register_telemetry)
    svc = RouterService(router)
    server.add_service(svc)
    if TELEMETRY_SERVICE not in server.services:
        register_telemetry(server, name=router.name)
    return svc


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class _ClientCollector:
    """Client stream handler: tokens + cursors + the terminal, with the
    session_id latched from the done message."""

    def __init__(self, emit: Optional[Callable[[int], None]] = None):
        self.tokens: list[int] = []
        self.cursor = 0
        self.session_id: Optional[str] = None
        self.error: Optional[int] = None
        self.done = threading.Event()
        self._emit = emit
        self._terminal_seen = False

    def on_received_messages(self, stream, messages):
        for m in messages:
            try:
                d = json.loads(m)
            except ValueError:
                continue
            if "token" in d:
                t = int(d["token"])
                self.tokens.append(t)
                self.cursor = int(d.get("cursor", self.cursor + 1))
                if self._emit is not None:
                    self._emit(t)
            if d.get("done"):
                self._terminal_seen = True
                if d.get("session_id"):
                    self.session_id = str(d["session_id"])
                if d.get("error"):
                    self.error = int(d["error"])
                self.done.set()

    def on_closed(self, stream):
        if not self._terminal_seen:
            self.error = errors.EFAILEDSOCKET
        self.done.set()

    def on_idle_timeout(self, stream):
        pass


class LiveGeneration:
    """One in-flight client-side generation: collects tokens, exposes
    the cursor, and can DROP the connection mid-stream (the client-
    failure half of a replica-kill scenario)."""

    def __init__(self, session_id: str, collector: _ClientCollector,
                 stream):
        self.session_id = session_id
        self._col = collector
        self._stream = stream

    @property
    def tokens(self) -> list[int]:
        return list(self._col.tokens)

    @property
    def cursor(self) -> int:
        return self._col.cursor

    @property
    def error(self) -> Optional[int]:
        return self._col.error

    def wait(self, timeout_s: float = 30.0) -> bool:
        return self._col.done.wait(timeout_s)

    def wait_tokens(self, n: int, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self._col.tokens) >= n or self._col.done.is_set():
                return len(self._col.tokens) >= n
            time.sleep(0.005)
        return False

    def drop(self) -> None:
        """Simulate the client dying: close the stream.  The session
        keeps decoding server-side; reconnect with ``session_id`` +
        ``cursor`` to resume."""
        try:
            self._stream.close()
        except Exception:
            pass
        self._col.done.set()


_RETRY_AFTER_RE = re.compile(r"retry_after_s=([0-9]+(?:\.[0-9]+)?)")


def parse_retry_after_s(text: str | None) -> Optional[float]:
    """The ``retry_after_s=<x>`` hint a router shed attaches to its
    ELIMIT text, or None when the error carries no hint."""
    if not text:
        return None
    m = _RETRY_AFTER_RE.search(text)
    return float(m.group(1)) if m else None


class RouterClient:
    """Thin client for the Router service: ``generate`` (blocking),
    ``start`` (live handle with ``drop()``), ``resume`` (reconnect).

    A router shed (ELIMIT carrying a ``retry_after_s``
    hint) is no longer just a text hint — ``start``/``generate`` back
    off for the HINTED delay (plus bounded jitter so a shed burst's
    clients don't re-arrive in lockstep) and retry, up to
    ``shed_retries`` attempts.  An ELIMIT without a hint, any other
    error, or an exhausted budget surfaces to the caller unchanged,
    and backoff sleeps count against the caller's deadline
    (``generate(timeout_s=...)`` / ``start(deadline_s=...)``): a
    retry whose delay would overshoot it surfaces the shed
    immediately instead of sleeping past the budget.  Set
    ``shed_retries=0`` to restore the raw single-attempt
    behavior."""

    def __init__(self, addr: str, *, timeout_ms: int = 10_000,
                 shed_retries: int = 3, max_backoff_s: float = 30.0,
                 jitter_frac: float = 0.1):
        from ..rpc.channel import Channel
        self.addr = addr
        self.timeout_ms = int(timeout_ms)
        self.shed_retries = int(shed_retries)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter_frac = float(jitter_frac)
        # observability for callers/tests: every backoff this client
        # actually slept, as (hinted_s, slept_s)
        self.backoffs: list = []
        self._ch = Channel(addr, timeout_ms=self.timeout_ms)

    def _shed_backoff_s(self, hint_s: float) -> float:
        import random
        jitter = random.uniform(0.0, self.jitter_frac * hint_s)
        return min(hint_s + jitter, self.max_backoff_s)

    def start(self, prompt: Sequence[int], max_new_tokens: int, *,
              emit: Optional[Callable[[int], None]] = None,
              deadline_s: Optional[float] = None,
              model: Optional[str] = None) -> LiveGeneration:
        attempt = 0
        deadline = (time.monotonic() + deadline_s) \
            if deadline_s is not None else None
        while True:
            try:
                return self._start_once(prompt, max_new_tokens,
                                        emit=emit, model=model)
            except errors.RpcError as e:
                hint = parse_retry_after_s(e.text) \
                    if e.code == errors.ELIMIT else None
                if hint is None or attempt >= self.shed_retries:
                    raise
                delay = self._shed_backoff_s(hint)
                if deadline is not None and \
                        time.monotonic() + delay > deadline:
                    # honoring the hint would overshoot the caller's
                    # budget: surface the shed now instead of sleeping
                    # past the deadline
                    raise
                attempt += 1
                self.backoffs.append((hint, delay))
                # honor the hint: earlier re-arrival would land inside
                # the same overload plateau and be shed again
                time.sleep(delay)

    def _start_once(self, prompt: Sequence[int], max_new_tokens: int, *,
                    emit: Optional[Callable[[int], None]] = None,
                    model: Optional[str] = None) -> LiveGeneration:
        from ..rpc.controller import Controller
        from ..rpc.stream import stream_create
        col = _ClientCollector(emit)
        cntl = Controller(timeout_ms=self.timeout_ms)
        stream = stream_create(cntl, col)
        req = {"prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens)}
        if model:
            req["model"] = str(model)
        try:
            resp = self._ch.call_sync(
                "Router", "Generate", req,
                serializer="json", cntl=cntl)
        except errors.RpcError:
            # shed (ELIMIT) or dead router: the never-bound stream
            # must close or it leaks in the StreamRegistry
            try:
                stream.close()
            except Exception:
                pass
            raise
        sid = str((resp or {}).get("session_id", ""))
        return LiveGeneration(sid, col, stream)

    def generate(self, prompt: Sequence[int], max_new_tokens: int, *,
                 emit: Optional[Callable[[int], None]] = None,
                 timeout_s: float = 30.0,
                 model: Optional[str] = None) -> dict:
        deadline = time.monotonic() + timeout_s
        gen = self.start(prompt, max_new_tokens, emit=emit,
                         deadline_s=timeout_s, model=model)
        if not gen.wait(max(0.0, deadline - time.monotonic())):
            raise errors.RpcError(errors.ERPCTIMEDOUT,
                                  "router generation never finished")
        return {"session_id": gen.session_id, "tokens": gen.tokens,
                "cursor": gen.cursor, "error": gen.error}

    def resume(self, session_id: str, cursor: int, *,
               emit: Optional[Callable[[int], None]] = None
               ) -> LiveGeneration:
        from ..rpc.controller import Controller
        from ..rpc.stream import stream_create
        col = _ClientCollector(emit)
        col.cursor = int(cursor)
        cntl = Controller(timeout_ms=self.timeout_ms)
        stream = stream_create(cntl, col)
        try:
            self._ch.call_sync(
                "Router", "Resume",
                {"session_id": str(session_id), "cursor": int(cursor)},
                serializer="json", cntl=cntl)
        except errors.RpcError:
            try:
                stream.close()
            except Exception:
                pass
            raise
        return LiveGeneration(str(session_id), col, stream)

    def resume_wait(self, session_id: str, cursor: int, *,
                    timeout_s: float = 30.0) -> dict:
        gen = self.resume(session_id, cursor)
        if not gen.wait(timeout_s):
            raise errors.RpcError(errors.ERPCTIMEDOUT,
                                  "router resume never finished")
        return {"session_id": session_id, "tokens": gen.tokens,
                "cursor": gen.cursor, "error": gen.error}
