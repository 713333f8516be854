"""PSClient: the embedding service's client-side router (the port of
``brpc_tpu/psserve/client.py``).

``lookup(keys)`` / ``update(keys, grads)`` take GLOBAL keys in request
order.  The client splits each request's key set by shard ownership
(:func:`~brpc_tpu_torch.psserve.shard.owners_for` over the contiguous
range map), fans the owned subsets out sub-call-per-partition through a
:class:`~brpc_tpu_torch.rpc.combo_channels.PartitionChannel` (failed
partitions re-issue, rotating replicas under ``lb=``), and reassembles
the responses IN KEY ORDER: duplicates and shard-straddling key sets
fall out of the position bookkeeping.

Updates are idempotent end to end: every sub-call carries a distinct
53-bit ``update_id`` (per-process random salt + process-wide counter +
partition), so a retry after a lost ack re-acks the ORIGINAL apply
instead of double scatter-adding; the shards' version counters show it.
``Pull``/``Push`` route dense parameters to an owner shard by stable
name hash.

The reference's other backend, a co-located lowered table reached
without a socket (``psserve/lowered.py``), belongs to the mesh slice
(ROADMAP Queue 1 item 9): here the backend is a PartitionChannel, and
``ici="auto"`` means the wire.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Optional

import numpy as np

from .. import errors
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder, LatencyRecorder
from ..rpc.combo_channels import PartitionChannel
from ..train.optimizer import OptimizerSpec
from .shard import owners_for, shard_bounds

CLIENT_LOOKUPS = Adder("psserve_client_lookups")
CLIENT_UPDATES = Adder("psserve_client_updates")
CLIENT_RETRIES = Adder("psserve_client_retries")
CLIENT_STALE_READS = Adder("psserve_client_stale_reads")
# binary-wire negotiation: a partition answering ENOMETHOD to
# LookupT/UpdateT is an old peer; it falls back to JSON, sticky per
# partition, and this counts each such downgrade
CLIENT_NEGOTIATION_FALLBACKS = Adder(
    "psserve_client_negotiation_fallbacks")

# the lookup latency recorder is native: made at the first lookup, not
# at import (importing the port loads no native core)
_latency_mu = InstrumentedLock("psserve.client_latency")
_lookup_latency: list = []


def _lookup_latency_recorder() -> LatencyRecorder:
    with _latency_mu:
        if not _lookup_latency:
            _lookup_latency.append(LatencyRecorder("psserve_client_lookup"))
        return _lookup_latency[0]


# update_id construction: ids stay unique across every client in every
# process sharing the shards (a collision silently drops a fresh update
# as a "duplicate"), and survive float64 packing exactly (<= 2^53).
# Layout: (18-bit per-process random salt << 30 | 30-bit process-wide
# counter) * n_shards + partition + 1; 48 bits of sequence times up to
# 32 shards tops out at exactly 2^53, which the service's inclusive
# bound accepts.
_uid_mu = InstrumentedLock("psserve.uid")
_uid_salt = int.from_bytes(os.urandom(3), "big") & 0x3FFFF
_uid_counter = [0]


def _next_uid_seq() -> int:
    global _uid_salt
    with _uid_mu:
        _uid_counter[0] += 1
        if _uid_counter[0] >= (1 << 30):
            # re-salt rather than wrap onto ids that may still sit in
            # a shard's applied window
            _uid_salt = int.from_bytes(os.urandom(3), "big") & 0x3FFFF
            _uid_counter[0] = 1
        return (_uid_salt << 30) | _uid_counter[0]


class PSClient:
    """Route Lookup/Update/Pull/Push over a partitioned embedding
    service: ``backend`` is a PartitionChannel with ``n_shards``
    partitions registered."""

    def __init__(self, backend, *, vocab: int, dim: int,
                 n_shards: Optional[int] = None,
                 timeout_ms: int = 5000, max_retry: int = 2,
                 name: str = "psclient",
                 serializer: str = "tensorframe",
                 ici: object = "auto", table_name: str = "ps"):
        if not isinstance(backend, PartitionChannel):
            raise TypeError(
                f"PSClient needs a PartitionChannel backend, got "
                f"{type(backend).__name__}: the lowered-table backend is "
                f"ROADMAP Queue 1 item 9 (the mesh slice)")
        if ici not in ("auto", "off", None, False):
            raise TypeError("ici= takes 'auto' or 'off': a lowered table "
                            "is ROADMAP Queue 1 item 9 (the mesh slice)")
        if serializer not in ("tensorframe", "json"):
            raise ValueError("serializer must be tensorframe|json, got "
                             f"{serializer!r}")
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.name = name
        self.timeout_ms = int(timeout_ms)
        self.max_retry = int(max_retry)
        # preferred wire format; per-partition negotiation downgrades
        # to "json" (sticky) when a partition answers ENOMETHOD to the
        # binary methods (an old peer)
        self.serializer = serializer
        self._wire_mode: dict[int, str] = {}
        self._ici_mode = ici
        self.table_name = str(table_name)
        self._pc = backend
        self.n_shards = int(n_shards or backend.partition_count)
        if self.n_shards > 32:
            raise ValueError("update_id space covers <= 32 shards")
        self.bounds = shard_bounds(self.vocab, self.n_shards)
        self._mu = InstrumentedLock("psserve.client")
        # read-your-writes bookkeeping: highest acked version per shard
        self.acked_version = [0] * self.n_shards
        self.n_lookups = 0
        self.n_updates = 0
        self.n_retries = 0
        self.n_stale_reads = 0
        self.n_negotiation_fallbacks = 0
        from . import _register_client
        _register_client(self)

    # ---- id + split helpers ----

    def _uid_for(self, token: int, part: int) -> int:
        """Per-partition update_id for one LOGICAL update: a pure
        function of (token, partition), so replaying a token re-sends
        the same ids and already-applied partitions dedup."""
        return token * self.n_shards + part + 1

    def _split(self, keys: np.ndarray) -> dict[int, np.ndarray]:
        """partition -> positions (indices into the request) owned."""
        owner = owners_for(keys, self.bounds)
        return {int(s): np.flatnonzero(owner == s)
                for s in np.unique(owner)}

    def _check_keys(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        if keys.ndim != 1:
            raise ValueError("keys must be 1-D")
        if keys.size and (keys.min() < 0 or keys.max() >= self.vocab):
            # a clear local error, not a permanent server EREQUEST
            # retried max_retry times (or ENODATA for a negative key's
            # partition)
            raise ValueError(f"keys outside [0, {self.vocab})")
        return keys

    # ---- Lookup ----

    def lookup(self, keys) -> np.ndarray:
        """rows [n, dim] for GLOBAL keys, reassembled in key order."""
        keys = self._check_keys(keys)
        t0 = time.monotonic()
        split = self._split(keys)
        resp = self._fan_out(
            split, "Lookup",
            lambda part, pos: {"keys": keys[pos].tolist()},
            lambda part, pos: {"keys": keys[pos]})
        rows = np.empty((keys.shape[0], self.dim), np.float32)
        for part, pos in split.items():
            r = resp[part]
            rows[pos] = np.asarray(r["rows"], np.float32)
            self._note_version(part, int(r.get("version", 0)))
        with self._mu:
            self.n_lookups += 1
        CLIENT_LOOKUPS.add(1)
        _lookup_latency_recorder().add(int((time.monotonic() - t0) * 1e6))
        return rows

    # ---- Update ----

    def update(self, keys, grads,
               update_token: Optional[int] = None,
               optimizer=None) -> dict[int, int]:
        """Sparse scatter-add; returns {partition: acked version}.
        Exactly once per partition even across retries (update_ids).

        With ``optimizer`` (an :class:`OptimizerSpec` or its wire dict)
        ``grads`` are RAW gradients and each shard runs the FUSED
        scatter+slot-step apply against its co-located momentum/Adam
        rows; the slots never cross the wire.  The spec rides the JSON
        wire as an ``"optimizer"`` object and the binary wire as
        flattened ``opt_*`` fields.

        If the fan-out fails PARTIALLY (some partitions acked, some
        exhausted their retries), the raised RpcError carries
        ``update_token``: replay the SAME logical update with
        ``update(keys, grads, update_token=e.update_token)`` and the
        partitions that already applied dedup instead of applying
        twice.  A retry WITHOUT the token mints fresh ids and
        re-applies everywhere."""
        keys = self._check_keys(keys)
        grads = np.asarray(grads, np.float32)
        if grads.shape != (keys.shape[0], self.dim):
            raise ValueError(f"grads shape {grads.shape} != "
                             f"({keys.shape[0]}, {self.dim})")
        spec = None if optimizer is None else \
            OptimizerSpec.from_wire(optimizer)
        token = update_token if update_token is not None \
            else _next_uid_seq()
        split = self._split(keys)

        def make_json(part, pos):
            req = {"keys": keys[pos].tolist(),
                   "grads": grads[pos].tolist(),
                   "update_id": self._uid_for(token, part)}
            if spec is not None:
                req["optimizer"] = spec.to_wire()
            return req

        def make_frame(part, pos):
            # tensors ride as raw int64/float32 bytes, never Python
            # lists; the optimizer spec flattens to inline scalar fields
            req = {"keys": keys[pos], "grads": grads[pos],
                   "update_id": self._uid_for(token, part)}
            if spec is not None:
                req.update(spec.to_frame_fields())
            return req

        try:
            resp = self._fan_out(split, "Update", make_json, make_frame)
        except errors.RpcError as e:
            # stamp the token so the caller can replay THIS logical
            # update idempotently (partitions that acked will dedup)
            e.update_token = token
            raise
        out = {}
        for part, r in resp.items():
            ver = int(r["version"])
            out[part] = ver
            self._note_ack(part, ver)
        with self._mu:
            self.n_updates += 1
        CLIENT_UPDATES.add(1)
        return out

    # ---- dense Pull/Push ----

    def _owner_of(self, pname: str) -> int:
        return zlib.crc32(pname.encode()) % self.n_shards

    def pull(self, pname: str) -> np.ndarray:
        part = self._owner_of(pname)
        r = self._call({part: {"name": pname}}, "Pull")[part]
        return np.asarray(r["value"], np.float32)

    def push(self, pname: str, delta) -> int:
        part = self._owner_of(pname)
        req = {part: {"name": pname,
                      "delta": np.asarray(delta, np.float32).tolist(),
                      "update_id": self._uid_for(_next_uid_seq(), part)}}
        r = self._call(req, "Push")[part]
        ver = int(r["version"])
        self._note_ack(part, ver)
        return ver

    # ---- fan-out plumbing ----

    def _call(self, sub_requests: dict, method: str,
              serializer: str = "json") -> dict:
        def on_retry(idx, err):
            with self._mu:
                self.n_retries += 1
            CLIENT_RETRIES.add(1)
        return self._pc.call_partitioned(
            "PS", method, sub_requests, serializer=serializer,
            timeout_ms=self.timeout_ms, max_retry=self.max_retry,
            on_retry=on_retry)

    def _mode_for(self, part: int) -> str:
        return self._wire_mode.get(part, self.serializer)

    def _mark_json(self, part: int) -> None:
        with self._mu:
            if self._wire_mode.get(part) == "json":
                return      # already downgraded (a concurrent fan-out
                            # won the race): count the change once
            self._wire_mode[part] = "json"
            self.n_negotiation_fallbacks += 1
        CLIENT_NEGOTIATION_FALLBACKS.add(1)

    @staticmethod
    def _group_failures(e, parts, out) -> dict:
        """One group call raised: absorb its partial responses into
        ``out`` and return {part: error} for the parts that failed (an
        error with no per-partition detail blames every unanswered
        part)."""
        out.update(getattr(e, "partial_responses", {}) or {})
        fj = getattr(e, "failed_partitions", None)
        if fj:
            return dict(fj)
        return {p: e for p in parts if p not in out}

    def _fan_out(self, split: dict, base_method: str,
                 make_json, make_frame) -> dict:
        """Issue one sub-call per partition in each partition's
        negotiated wire format: ``base_method`` + JSON for "json"
        partitions, ``base_method + "T"`` + tensorframe for binary ones;
        the two groups run CONCURRENTLY.  A binary partition failing
        ENOMETHOD is an OLD PEER: it downgrades to JSON (sticky) and its
        sub-call re-issues (sub-requests are idempotent: per-partition
        update_ids are a pure function of the logical token).  On any
        partition failing for real, ONE error aggregates the whole
        fan-out (a single shared code preserved, else ETOOMANYFAILS;
        failed_partitions + partial_responses carry the detail)."""
        modes = {part: self._mode_for(part) for part in split}
        out: dict = {}
        failures: dict = {}
        bin_parts = [p for p in split if modes[p] == "tensorframe"]
        json_parts = [p for p in split if modes[p] == "json"]

        json_out: dict = {}
        json_exc: list = [None]

        def run_json(parts):
            sub = {p: make_json(p, split[p]) for p in parts}
            try:
                json_out.update(self._call(sub, base_method,
                                           serializer="json"))
            except errors.RpcError as e:
                json_exc[0] = e
            except Exception as e:     # a non-Rpc bug must not leave
                # the group silently unanswered
                json_exc[0] = errors.RpcError(
                    errors.EINTERNAL,
                    f"json fan-out failed: {type(e).__name__}: {e}")

        jt = None
        if json_parts:
            if bin_parts:
                # one short-lived thread per MIXED-fleet call (the
                # rolling-upgrade state); steady fleets take one group
                jt = threading.Thread(target=run_json,
                                      args=(json_parts,), daemon=True)
                jt.start()
            else:
                run_json(json_parts)

        fallback = []
        if bin_parts:
            sub = {p: make_frame(p, split[p]) for p in bin_parts}
            try:
                out.update(self._call(sub, base_method + "T",
                                      serializer="tensorframe"))
            except errors.RpcError as e:
                for p, err in self._group_failures(
                        e, bin_parts, out).items():
                    if isinstance(err, errors.RpcError) \
                            and err.code == errors.ENOMETHOD:
                        self._mark_json(p)
                        fallback.append(p)
                    else:
                        failures[p] = err
        if fallback:
            # one-time re-issue for freshly downgraded old peers
            sub = {p: make_json(p, split[p]) for p in fallback}
            try:
                out.update(self._call(sub, base_method,
                                      serializer="json"))
            except errors.RpcError as e:
                failures.update(self._group_failures(e, fallback, out))
        if jt is not None:
            jt.join()
        out.update(json_out)
        if json_exc[0] is not None:
            failures.update(self._group_failures(json_exc[0],
                                                 json_parts, out))
        if failures:
            codes = {err.code for err in failures.values()
                     if isinstance(err, errors.RpcError)}
            code = codes.pop() if len(codes) == 1 \
                else errors.ETOOMANYFAILS
            first_p = next(iter(failures))
            err = errors.RpcError(
                code, f"{len(failures)}/{len(split)} partitions "
                      f"failed (first: partition {first_p}: "
                      f"{failures[first_p]})")
            err.failed_partitions = dict(failures)
            err.partial_responses = dict(out)
            raise err
        return out

    def _note_ack(self, part: int, ver: int) -> None:
        with self._mu:
            if ver > self.acked_version[part]:
                self.acked_version[part] = ver

    def _note_version(self, part: int, ver: int) -> None:
        """Read-your-writes check: a lookup must observe every update
        THIS client already got acked on that shard."""
        with self._mu:
            if ver < self.acked_version[part]:
                self.n_stale_reads += 1
                CLIENT_STALE_READS.add(1)

    def close(self) -> None:
        self._pc.close()

    def stats(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "n_shards": self.n_shards,
                "backend": "partition_channel",
                "serializer": self.serializer,
                "wire_modes": dict(self._wire_mode),
                "negotiation_fallbacks": self.n_negotiation_fallbacks,
                "lookups": self.n_lookups,
                "updates": self.n_updates,
                "stale_reads": self.n_stale_reads,
                "acked_versions": list(self.acked_version),
            }
