"""Combo channels (a copy of ``brpc_tpu/rpc/combo_channels.py``).

  ParallelChannel   one call fans out to N sub-channels; a CallMapper
                    slices or clones the request per sub-channel, a
                    ResponseMerger folds the sub-responses, fail_limit
                    bounds the tolerated failures.
  SelectiveChannel  a channel of channels with its own balancer; retries
                    a DIFFERENT sub-channel on failure.
  PartitionChannel  shards requests over partitioned servers, through a
                    PartitionParser on the servers' tags or partitions
                    registered directly; ``call_partitioned`` is the
                    retrying one-sub-call-per-partition fan-out.
  DynamicPartitionChannel  several partition schemes in one naming
                    service, traffic weighted by each scheme's capacity.

Left out (ROADMAP Queue 1 item 9, the mesh slice): the collective
lowering, which runs a fan-out over co-located devices as one program;
a port ParallelChannel always takes the per-channel path.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from .. import errors
from .channel import Channel, ChannelOptions, RetryPolicy, SocketMap
from .controller import Controller, OneShotEvent


class SubCall:
    """What CallMapper returns for one sub-channel: its request (or SKIP)."""

    __slots__ = ("request", "skip")

    def __init__(self, request: Any = None, skip: bool = False):
        self.request = request
        self.skip = skip

    @classmethod
    def skip_call(cls) -> "SubCall":
        return cls(skip=True)


class CallMapper:
    """Map(channel_index, request) -> SubCall (parallel_channel.h:94)."""

    def map(self, channel_index: int, nchannels: int, request: Any) -> SubCall:
        return SubCall(request)   # default: broadcast the same request


class ResponseMerger:
    """merge(responses) -> merged response.  Default returns the list."""

    def merge(self, responses: list) -> Any:
        return responses


class SumMerger(ResponseMerger):
    """Elementwise sum of the sub-responses."""

    def merge(self, responses: list) -> Any:
        out = responses[0]
        for r in responses[1:]:
            out = out + r
        return out


class ParallelChannel:
    def __init__(self, fail_limit: int = 0,
                 call_mapper: CallMapper | None = None,
                 response_merger: ResponseMerger | None = None):
        self._channels: list[tuple[Channel, CallMapper | None]] = []
        self.fail_limit = fail_limit        # 0 = tolerate none
        self.call_mapper = call_mapper or CallMapper()
        self.response_merger = response_merger or ResponseMerger()

    def add_channel(self, channel: Channel,
                    call_mapper: CallMapper | None = None) -> "ParallelChannel":
        self._channels.append((channel, call_mapper))
        return self

    @property
    def channel_count(self) -> int:
        return len(self._channels)

    def call(self, service: str, method: str, request: Any = b"",
             cntl: Controller | None = None, serializer: str = "raw",
             done: Callable[[Controller], None] | None = None) -> Controller:
        cntl = cntl or Controller()
        n = len(self._channels)
        if n == 0:
            cntl.set_failed(errors.ENODATA, "no sub-channels")
            if done:
                done(cntl)
            return cntl
        if done is None:
            cntl._done_event = OneShotEvent()

        sub_cntls: list[Optional[Controller]] = [None] * n
        results: list[Any] = [None] * n
        skipped = [False] * n
        state = {"left": 0, "failed": 0}
        lock = threading.Lock()

        def finish():
            fails = state["failed"]
            if fails > self.fail_limit:
                first_err = next((c for c in sub_cntls
                                  if c is not None and c.failed()), None)
                cntl.set_failed(
                    errors.ETOOMANYFAILS,
                    f"{fails}/{n} sub-calls failed"
                    + (f" (first: E{first_err.error_code} "
                       f"{first_err.error_text})" if first_err else ""))
            else:
                ok = [r for i, r in enumerate(results) if not skipped[i]
                      and sub_cntls[i] is not None
                      and not sub_cntls[i].failed()]
                try:
                    cntl.response = self.response_merger.merge(ok)
                except Exception as e:
                    cntl.set_failed(errors.ERESPONSE, f"merge failed: {e}")
            if done is not None:
                done(cntl)
            if cntl._done_event is not None:
                cntl._done_event.set()

        # map first so skips don't count toward `left`
        mapped: list[Optional[SubCall]] = []
        for i, (ch, mapper) in enumerate(self._channels):
            m = (mapper or self.call_mapper).map(i, n, request)
            if m is None or m.skip:
                skipped[i] = True
                mapped.append(None)
            else:
                mapped.append(m)
                state["left"] += 1
        if state["left"] == 0:
            cntl.set_failed(errors.ENODATA, "all sub-calls skipped")
            if done:
                done(cntl)
            if cntl._done_event is not None:
                cntl._done_event.set()
            return cntl

        def make_done(i):
            def _done(sub):
                with lock:
                    if sub.failed():
                        state["failed"] += 1
                    else:
                        results[i] = sub.response
                    state["left"] -= 1
                    last = state["left"] == 0
                if last:
                    finish()
            return _done

        for i, (ch, _mapper) in enumerate(self._channels):
            if skipped[i]:
                continue
            sub = Controller(timeout_ms=cntl.timeout_ms,
                             max_retry=cntl.max_retry)
            sub_cntls[i] = sub
            ch.call(service, method, mapped[i].request, cntl=sub,
                    serializer=serializer, done=make_done(i))
        return cntl

    def call_sync(self, service: str, method: str, request: Any = b"",
                  serializer: str = "raw", **kw) -> Any:
        cntl = self.call(service, method, request, serializer=serializer, **kw)
        cntl.join()
        cntl.raise_if_failed()
        return cntl.response


class SelectiveChannel:
    """Retries a different sub-channel on failure; its own LB over
    sub-channels (selective_channel.h:52-69).

    By default selection is round-robin over the registered
    sub-channels.  With ``lb=`` (any
    :class:`~brpc_tpu_torch.policy.load_balancer.LoadBalancer`, e.g.
    ``prefix_affinity``) and endpoints supplied to ``add_channel``,
    selection is DELEGATED to the balancer — health-check broken
    endpoints are skipped, the circuit breaker's recovery ramp
    applies, and ``request_code`` routes consistently (the cluster
    router's forward path).  ``pick``/``feedback`` expose the
    per-attempt machinery to callers (streaming RPCs) that must drive
    each attempt themselves rather than through ``call_sync``."""

    def __init__(self, max_retry: int = 3, lb=None):
        self._channels: list[Channel] = []
        self._endpoints: list = []       # parallel to _channels (or None)
        self.max_retry = max_retry
        self._lb = lb
        self._counter = 0
        self._lock = threading.Lock()

    def add_channel(self, channel: Channel,
                    endpoint=None) -> "SelectiveChannel":
        if endpoint is None:
            endpoint = getattr(channel, "_endpoint", None)
        self._channels.append(channel)
        self._endpoints.append(endpoint)
        if self._lb is not None and endpoint is not None:
            from ..policy.load_balancer import ServerNode
            self._lb.add_server(ServerNode(endpoint))
        return self

    @property
    def channel_count(self) -> int:
        return len(self._channels)

    def _index_of(self, endpoint) -> Optional[int]:
        for i, ep in enumerate(self._endpoints):
            if ep == endpoint:
                return i
        return None

    def pick(self, exclude=None, request_code: Optional[int] = None):
        """One selection: ``(index, channel, endpoint)`` or ``None``
        when nothing is selectable.  ``exclude`` is a set of endpoints
        (lb mode) or indices (round-robin mode) already tried."""
        if self._lb is not None:
            ep = self._lb.select_server(exclude=exclude or set(),
                                        request_code=request_code)
            if ep is None:
                return None
            i = self._index_of(ep)
            if i is None:
                return None
            return i, self._channels[i], ep
        i = self._pick(exclude or set())
        if i is None:
            return None
        return i, self._channels[i], self._endpoints[i]

    def feedback(self, endpoint, error_code: int,
                 latency_us: int = 0, *, breaker: bool = True) -> None:
        """Report one attempt's outcome: the balancer adjusts its
        weights and (with ``breaker=True``) the global circuit breaker
        accumulates the endpoint's error/latency evidence.  Callers
        whose attempt already rode a sub-channel ``call_sync`` pass
        ``breaker=False`` — the channel layer fed the breaker itself,
        and double-counting would halve its isolation thresholds."""
        if endpoint is None:
            return
        if self._lb is not None:
            self._lb.feedback(endpoint, error_code, latency_us)
        if breaker:
            from ..policy.circuit_breaker import global_breaker
            global_breaker().on_call_end(endpoint, error_code, latency_us)

    def _pick(self, exclude: set[int]) -> Optional[int]:
        with self._lock:
            n = len(self._channels)
            for _ in range(n):
                i = self._counter % n
                self._counter += 1
                if i not in exclude:
                    return i
        return None

    def call_sync(self, service: str, method: str, request: Any = b"",
                  serializer: str = "raw", cntl: Controller | None = None) -> Any:
        if not self._channels:
            raise errors.RpcError(errors.ENODATA, "no sub-channels")
        tried: set[int] = set()
        tried_eps: set = set()
        last: Exception | None = None
        max_retry = cntl.max_retry if cntl is not None and \
            cntl.max_retry is not None else self.max_retry
        req_code = cntl.request_code if cntl is not None else None
        for _ in range(min(max_retry + 1, len(self._channels))):
            picked = self.pick(
                exclude=tried_eps if self._lb is not None else tried,
                request_code=req_code)
            if picked is None:
                break
            i, _chan, ep = picked
            if i in tried:
                break     # balancer re-offered an already-tried replica
            tried.add(i)
            if ep is not None:
                tried_eps.add(ep)
            sub = Controller(timeout_ms=cntl.timeout_ms if cntl else None)
            try:
                resp = self._channels[i].call_sync(
                    service, method, request, serializer=serializer,
                    cntl=sub)
                self.feedback(ep, 0, sub.latency_us or 0, breaker=False)
                if cntl is not None:
                    # callers follow the Channel contract: results land on
                    # the controller they passed in
                    cntl.reset_for_retry()
                    cntl.response = sub.response
                    cntl.response_attachment = sub.response_attachment
                    cntl.remote_side = sub.remote_side
                    cntl.latency_us = sub.latency_us
                    cntl.retried_count = len(tried) - 1
                return resp
            except errors.RpcError as e:
                last = e
                self.feedback(ep, e.code, sub.latency_us or 0,
                              breaker=False)
                if cntl is not None:
                    cntl.set_failed(sub.error_code, sub.error_text)
                    cntl.remote_side = sub.remote_side
                    cntl.retried_count = len(tried) - 1
                continue
        raise last or errors.RpcError(errors.ETOOMANYFAILS)


class PartitionParser:
    """tag -> (partition_index, partition_count), e.g. "2/8" like the
    reference's "N/M" scheme (partition_channel.h)."""

    def parse(self, tag: str) -> Optional[tuple[int, int]]:
        try:
            idx, _, cnt = tag.partition("/")
            return int(idx), int(cnt)
        except ValueError:
            return None


class PartitionChannel:
    """One channel per partition, built from ONE naming service whose nodes
    carry partition tags; call() fans out one sub-request per partition via
    a CallMapper that receives the partition index.

    Partitions can also be registered DIRECTLY (``add_partition``) —
    the psserve client path, where the caller computes ownership and
    drives one sub-call per partition itself.  With ``lb=`` (a
    ``create_load_balancer`` spec or a factory returning LoadBalancer
    instances) a partition with several replicas selects through its
    own balancer exactly the way SelectiveChannel does:
    ``pick``/``feedback`` expose the per-attempt machinery, health-
    broken replicas are skipped, and the circuit breaker's evidence
    accumulates.  ``call_partitioned`` is the retrying fan-out:
    one sub-call per partition, failed partitions re-issued (a replica
    rotation under ``lb=``) up to ``max_retry`` times — callers make
    retries safe with idempotent sub-requests (psserve update_ids).
    NOTE: idempotence-by-id only holds when a partition's replicas
    SHARE the dedup state (one shard object, or replicated applied
    sets) — replicas with independent state will double-apply a
    rotated retry of a mutating sub-call; register independent
    replicas for read traffic only."""

    def __init__(self, partition_count: int,
                 call_mapper: CallMapper | None = None,
                 response_merger: ResponseMerger | None = None,
                 fail_limit: int = 0, lb=None):
        self.partition_count = partition_count
        self._parallel = ParallelChannel(fail_limit, call_mapper,
                                         response_merger)
        self._partitions: dict[int, Channel] = {}
        self._lb_spec = lb
        self._ns_threads: list = []

    def _make_lb(self):
        if self._lb_spec is None:
            return None
        if callable(self._lb_spec) and not isinstance(self._lb_spec, str):
            return self._lb_spec()
        from ..policy.load_balancer import create_load_balancer
        return create_load_balancer(self._lb_spec)

    def init(self, naming_url: str, load_balancer: str = "rr",
             parser: PartitionParser | None = None,
             options: ChannelOptions | None = None) -> "PartitionChannel":
        from ..policy.load_balancer import create_load_balancer
        from ..policy.naming import NamingServiceFilter, start_naming_service
        parser = parser or PartitionParser()

        class _PartFilter(NamingServiceFilter):
            def __init__(self, idx, count):
                self.idx = idx
                self.count = count

            def accept(self, node):
                p = parser.parse(node.tag)
                return p is not None and p[0] == self.idx and \
                    p[1] == self.count

        for idx in range(self.partition_count):
            lb = create_load_balancer(load_balancer)
            self._ns_threads.append(start_naming_service(
                naming_url, lb, _PartFilter(idx, self.partition_count)))
            ch = Channel(options=options or ChannelOptions())
            ch._lb = lb
            self._partitions[idx] = ch
            self._parallel.add_channel(ch)
        return self

    def add_partition(self, idx: int, channel: Channel,
                      endpoint=None) -> "PartitionChannel":
        """Register one replica of partition ``idx`` directly (no
        naming service).  A second replica for the same partition
        promotes it to a SelectiveChannel (balancer = ``lb=`` when
        given, round-robin otherwise) so the fan-out retries a
        DIFFERENT replica on failure."""
        if not (0 <= idx < self.partition_count):
            raise ValueError(f"partition {idx} out of range "
                             f"0..{self.partition_count - 1}")
        cur = self._partitions.get(idx)
        if cur is None:
            if self._lb_spec is not None:
                sc = SelectiveChannel(lb=self._make_lb())
                sc.add_channel(channel, endpoint=endpoint)
                self._partitions[idx] = sc
            else:
                self._partitions[idx] = channel
            # keep the ParallelChannel fan-out path coherent with the
            # direct registration (call()/call_sync() still work)
            self._parallel.add_channel(self._partitions[idx])
        elif isinstance(cur, SelectiveChannel):
            cur.add_channel(channel, endpoint=endpoint)
        else:
            sc = SelectiveChannel(lb=self._make_lb())
            sc.add_channel(cur, endpoint=getattr(cur, "_endpoint", None))
            sc.add_channel(channel, endpoint=endpoint)
            self._partitions[idx] = sc
            # swap inside the parallel fan-out list too
            for i, (ch, m) in enumerate(self._parallel._channels):
                if ch is cur:
                    self._parallel._channels[i] = (sc, m)
                    break
        return self

    def channel_for(self, idx: int) -> Optional[Channel]:
        return self._partitions.get(idx)

    def pick(self, idx: int, exclude=None, request_code=None):
        """One replica selection for partition ``idx`` — delegates to
        the partition's SelectiveChannel when it has one (lb mode),
        else returns the partition's only channel."""
        ch = self._partitions.get(idx)
        if ch is None:
            return None
        if isinstance(ch, SelectiveChannel):
            return ch.pick(exclude=exclude, request_code=request_code)
        return 0, ch, getattr(ch, "_endpoint", None)

    def feedback(self, idx: int, endpoint, error_code: int,
                 latency_us: int = 0, *, breaker: bool = True) -> None:
        """Report one sub-call attempt's outcome for partition ``idx``
        (the SelectiveChannel parity surface)."""
        ch = self._partitions.get(idx)
        if isinstance(ch, SelectiveChannel):
            ch.feedback(endpoint, error_code, latency_us,
                        breaker=breaker)

    # ---- the retrying sub-call-per-partition fan-out ----

    def _issue_one(self, idx, ch, req, cntl, service, method,
                   serializer, tried_eps, failed, pending) -> None:
        """Issue one partition's attempt without blocking (the round
        loop joins later).  lb-mode partitions pick a replica with
        rotation; once every replica was tried this rotation, the
        exclusion set RESETS so the retry budget stays max_retry+1
        attempts, not the replica count."""
        if isinstance(ch, SelectiveChannel):
            picked = ch.pick(exclude=tried_eps[idx])
            if picked is None and tried_eps[idx]:
                tried_eps[idx].clear()
                picked = ch.pick(exclude=tried_eps[idx])
            if picked is None:
                failed.setdefault(
                    idx, errors.RpcError(errors.ENODATA,
                                         "no selectable replica left"))
                return
            _i, sub_ch, ep = picked
            # exclusion keys match pick()'s contract: endpoints in lb
            # mode, channel indices in round-robin mode
            tried_eps[idx].add(ep if ch._lb is not None else _i)
            # _sync_join: the round loop's join IS the deadline timer
            # (the call_sync discipline) — no native timer arm+cancel
            # per sub-call
            sub_ch.call(service, method, req, cntl=cntl,
                        serializer=serializer, _sync_join=True)
            pending.append((idx, cntl, (ch, ep)))
        else:
            ch.call(service, method, req, cntl=cntl,
                    serializer=serializer, _sync_join=True)
            pending.append((idx, cntl, None))

    def call_partitioned(self, service: str, method: str,
                         sub_requests: dict,
                         serializer: str = "json",
                         timeout_ms: Optional[int] = None,
                         max_retry: int = 2,
                         on_retry: Callable | None = None) -> dict:
        """Fan ``sub_requests[idx]`` out as one sub-call per partition
        (concurrently), retrying each failed partition up to
        ``max_retry`` more times — under ``lb=`` every retry rotates to
        a different replica via the partition's balancer, which also
        receives each attempt's outcome.  Returns ``{idx: response}``;
        raises
        ETOOMANYFAILS when any partition exhausts its attempts (callers
        keep retried sub-requests idempotent)."""
        if not sub_requests:
            return {}
        missing = [i for i in sub_requests if i not in self._partitions]
        if missing:
            raise errors.RpcError(errors.ENODATA,
                                  f"no channel for partitions {missing}")

        # ROUND-BASED ASYNC fan-out: every round ISSUES all
        # still-pending sub-calls without blocking (Channel.call with a
        # join handle, no pool thread per partition), then joins them
        # in order.  Failed
        # retryable partitions re-issue in the NEXT round, up to
        # max_retry extra rounds — identical attempt/rotation semantics
        # to the per-partition retry loop, batched by round (retries
        # are the exception path; paying round latency there is free).
        # lb-mode partitions (SelectiveChannel) drive pick()/feedback()
        # per attempt — the exposed per-attempt machinery — so replica
        # rotation and balancer/breaker evidence behave exactly as the
        # SelectiveChannel.call_sync loop (breaker fed by the channel
        # layer; feedback(breaker=False)).
        out: dict = {}
        failed: dict = {}
        tried_eps: dict = {idx: set() for idx in sub_requests}
        todo = list(sub_requests)
        for _round in range(max_retry + 1):
            pending = []    # (idx, cntl, endpoint-for-feedback)
            for idx in todo:
                req = sub_requests[idx]
                ch = self._partitions[idx]
                cntl = Controller(timeout_ms=timeout_ms)
                try:
                    self._issue_one(idx, ch, req, cntl, service, method,
                                    serializer, tried_eps, failed,
                                    pending)
                except errors.RpcError as e:
                    failed[idx] = e
                except Exception as e:
                    # an issue-phase bug (encode failure, ...) must not
                    # escape raw and abandon the already-issued
                    # sub-calls un-joined — classify it and keep
                    # draining the round
                    failed[idx] = errors.RpcError(
                        errors.EINTERNAL,
                        f"sub-call issue failed: "
                        f"{type(e).__name__}: {e}")
            todo = []
            for idx, cntl, fb in pending:
                cntl.join()
                if fb is not None:
                    sel, ep = fb
                    sel.feedback(ep, cntl.error_code,
                                 cntl.latency_us or 0, breaker=False)
                if not cntl.failed():
                    out[idx] = cntl.response
                    failed.pop(idx, None)
                    continue
                e = errors.RpcError(cntl.error_code,
                                    cntl.error_text
                                    or errors.describe(cntl.error_code))
                failed[idx] = e
                if e.code not in RetryPolicy.RETRYABLE:
                    # EREQUEST/ENODATA/ENOMETHOD/... are deterministic:
                    # re-issuing the identical sub-call cannot succeed
                    # (reference retry_policy.h semantics)
                    continue
                if _round < max_retry:
                    if on_retry is not None:
                        on_retry(idx, e)   # another attempt follows
                    todo.append(idx)
            if not todo:
                break
        if failed:
            first = next(iter(failed.values()))
            codes = {e.code for e in failed.values()
                     if isinstance(e, errors.RpcError)}
            # one distinct underlying code: surface IT (a caller
            # switching on e.code must see ENODATA for a missing
            # param, not a generic ETOOMANYFAILS); mixed codes keep
            # the aggregate
            code = codes.pop() if len(codes) == 1 \
                else errors.ETOOMANYFAILS
            err = errors.RpcError(
                code,
                f"{len(failed)}/{len(sub_requests)} partitions failed"
                f" (first: partition {next(iter(failed))}: {first})")
            err.failed_partitions = dict(failed)
            err.partial_responses = dict(out)
            raise err
        return out

    def close(self) -> None:
        """Stop the partitions' naming-service refreshers (``init``)."""
        for t in self._ns_threads:
            t.stop()

    def call(self, *a, **kw):
        return self._parallel.call(*a, **kw)

    def call_sync(self, *a, **kw):
        return self._parallel.call_sync(*a, **kw)

    @property
    def channel_count(self):
        return self._parallel.channel_count


class DynamicPartitionChannel:
    """Mixes multiple partition schemes living in ONE naming service,
    weighting traffic by each scheme's capacity (reference
    DynamicPartitionChannel, partition_channel.h:120-168): servers tagged
    "0/4".."3/4" and "0/8".."7/8" coexist, and calls pick a scheme with
    probability proportional to its server count, so capacity can migrate
    between schemes by re-tagging servers — no client restart.

    This object IS the naming-service sink (reset_servers), so membership
    changes re-group schemes live, the way the reference's sub-channels
    subscribe to one NamingServiceThread."""

    def __init__(self, call_mapper: CallMapper | None = None,
                 response_merger: ResponseMerger | None = None,
                 fail_limit: int = 0,
                 parser: PartitionParser | None = None,
                 options: ChannelOptions | None = None):
        self.call_mapper = call_mapper
        self.response_merger = response_merger
        self.fail_limit = fail_limit
        self._parser = parser or PartitionParser()
        self._options = options or ChannelOptions()
        self._mu = threading.Lock()
        # scheme (partition_count) -> [servers per partition index]
        self._schemes: dict[int, list[list]] = {}
        self._channels: dict = {}      # endpoint -> single-server Channel
        self._rr = 0
        self._ns_thread = None

    # ---- naming-service sink (NamingServiceActions analog) ----

    def reset_servers(self, nodes) -> None:
        schemes: dict[int, list[list]] = {}
        for n in nodes:
            p = self._parser.parse(n.tag)
            if p is None:
                continue
            idx, cnt = p
            if cnt <= 0 or not (0 <= idx < cnt):
                continue
            parts = schemes.setdefault(cnt, [[] for _ in range(cnt)])
            parts[idx].append(n.endpoint)
        # only schemes with every partition populated are callable
        live = {n.endpoint for n in nodes}
        with self._mu:
            self._schemes = {cnt: parts for cnt, parts in schemes.items()
                             if all(parts)}
            departed = [ep for ep in self._channels if ep not in live]
            for ep in departed:
                del self._channels[ep]
        # evict departed servers' CONNECTIONS too (they're owned by the
        # process-wide SocketMap, not the Channel wrapper) so elastic
        # membership churn doesn't leak sockets
        for ep in departed:
            SocketMap.instance().drop(ep)

    def init(self, naming_url: str,
             options: ChannelOptions | None = None
             ) -> "DynamicPartitionChannel":
        if options is not None:
            self._options = options
        from ..policy.naming import start_naming_service
        self._ns_thread = start_naming_service(naming_url, self)
        self._ns_thread.wait_first_resolution()
        return self

    def stop(self) -> None:
        if self._ns_thread is not None:
            self._ns_thread.stop()

    @property
    def scheme_counts(self) -> dict[int, int]:
        with self._mu:
            return {cnt: sum(len(p) for p in parts)
                    for cnt, parts in self._schemes.items()}

    def _channel_for(self, endpoint) -> Channel:
        ch = self._channels.get(endpoint)
        if ch is None:
            ch = Channel(str(endpoint), options=self._options)
            self._channels[endpoint] = ch
        return ch

    def _pick_scheme(self):
        """Weight by scheme capacity = number of servers carrying its tags
        (the dynpart weighting, policy/dynpart_load_balancer.cpp)."""
        import random
        with self._mu:
            if not self._schemes:
                return None, None
            weights = [(cnt, sum(len(p) for p in parts))
                       for cnt, parts in self._schemes.items()]
            total = sum(w for _, w in weights)
            r = random.uniform(0, total)
            acc = 0.0
            for cnt, w in weights:
                acc += w
                if r <= acc:
                    break
            parts = self._schemes[cnt]
            self._rr += 1
            chosen = [p[self._rr % len(p)] for p in parts]
            return cnt, [self._channel_for(ep) for ep in chosen]

    def call(self, service: str, method: str, request: Any = b"",
             cntl: Controller | None = None, serializer: str = "raw",
             done: Callable[[Controller], None] | None = None) -> Controller:
        cnt, chans = self._pick_scheme()
        if chans is None:
            cntl = cntl or Controller()
            cntl.set_failed(errors.ENODATA,
                            "no complete partition scheme resolved")
            if done:
                done(cntl)
            else:
                cntl._done_event = OneShotEvent()
                cntl._done_event.set()
            return cntl
        pc = ParallelChannel(self.fail_limit, self.call_mapper,
                             self.response_merger)
        for ch in chans:
            pc.add_channel(ch)
        return pc.call(service, method, request, cntl=cntl,
                       serializer=serializer, done=done)

    def call_sync(self, service: str, method: str, request: Any = b"",
                  serializer: str = "raw", timeout_s: float = 10.0, **kw):
        cntl = kw.pop("cntl", None) or Controller()
        if cntl.timeout_ms is None:
            # join() only bounds its wait when the controller carries a
            # deadline — without this the timeout_s parameter would be a
            # silent no-op
            cntl.timeout_ms = int(timeout_s * 1000)
        cntl = self.call(service, method, request, cntl=cntl,
                         serializer=serializer, **kw)
        cntl.join()
        cntl.raise_if_failed()
        return cntl.response
