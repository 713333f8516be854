"""PS service registration: one shard's RPC surface (the port of
``brpc_tpu/psserve/service.py``, on the port's RPC front, tensorframe
and ``DynamicBatcher``).

``PS.Lookup`` / ``PS.Update`` / ``PS.Pull`` / ``PS.Push`` / ``PS.Stats``
ride the normal dispatch path (auth, interceptors, limiters,
MethodStatus all apply).  With ``batch=True`` (the default) concurrent
Lookup and Update RPCs COALESCE through two DynamicBatchers — the first
non-autoregressive traffic shape the batcher has ever coalesced:

  * lookups queue as int64 key vectors, bucket-padded by KEY COUNT; one
    [B, Lb] -> [B, Lb, D] gather on the shard's device serves the whole
    batch;
  * updates queue as packed float64 rows (update_id + interleaved
    key/grad groups, length buckets 1 + k*(1+D)); one scatter-add
    applies the whole batch, with idempotence decided per row at apply
    time under the shard lock.

``PS.LookupT`` / ``PS.UpdateT`` are the same semantics over
the BINARY tensor wire (rpc/tensorframe.py): requests arrive as frames
whose tensors are zero-copy views over the transport body, lookups
submit the int64 key view straight to the batcher, and updates pack
byte records (no float64 round-trip) into a third uint8-record
batcher — all three batchers default to EAGER mode (idle cut-through,
no window wait; see register_psserve), and an idle-batcher request
bypasses the defer machinery entirely.  Per-serializer request/wire-
byte Adders feed ``psserve_snapshot``.

Fault sites ``fault.PS_LOOKUP`` / ``fault.PS_UPDATE`` cover the
fan-out's failure modes on BOTH wires: ``stage="pre"`` fails a sub-call
before any apply, ``stage="post"`` drops the ack AFTER the apply, and
the retried sub-call must then dedup (the version counter advances
exactly once); ``fault.PS_OPT_APPLY`` does the same around the fused
optimizer apply.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import errors, fault
from ..bvar import Adder
from ..rpc.service import Service, method
from ..serving.batcher import DynamicBatcher
from ..train.optimizer import OptimizerSpec
from .shard import LOOKUP_KEYS, LOOKUPS, UPDATE_KEYS, EmbeddingShardServer

# per-serializer wire accounting: request counts and REQUEST-direction
# wire bytes per format, from the decode phase's exact
# cntl.request_body_size
REQUESTS_JSON = Adder("psserve_requests_json")
REQUESTS_TENSORFRAME = Adder("psserve_requests_tensorframe")
WIRE_BYTES_JSON = Adder("psserve_wire_bytes_json")
WIRE_BYTES_TENSORFRAME = Adder("psserve_wire_bytes_tensorframe")


def _coerce_uid(uid):
    """ONE update_id validation for BOTH wires (a retry may cross
    formats after a negotiation fallback and the dedup set is shared,
    so accept/reject must not differ): integers (and integral floats —
    some JSON encoders emit 123.0) in (0, 2**53]; strings and
    fractional floats are refused — int("123")/int(123.9) coercion
    would record the apply under an id the caller never sent, the
    exact rounded-onto-another-id hazard the bound exists to refuse.
    Returns (ok, value, error_text)."""
    if uid is None:
        return True, None, ""
    if isinstance(uid, bool) or not isinstance(uid, (int, float)):
        return False, None, "update_id must be an integer"
    if isinstance(uid, float):
        if not uid.is_integer():
            return False, None, "update_id must be an integer"
        uid = int(uid)
    if not (0 < uid <= (1 << 53)):
        # inclusive upper bound: 2**53 itself is exactly representable
        # in float64 (it's 2**53 + 1 that isn't), and PSClient's max
        # mintable id lands exactly there (salt/counter saturated at
        # n_shards=32)
        return False, None, "update_id must be in (0, 2**53]"
    return True, uid, ""


def wire_counters() -> dict:
    """The per-serializer counters as one dict (``psserve_snapshot``'s
    "wire" section)."""
    return {
        "requests_json": REQUESTS_JSON.get_value(),
        "requests_tensorframe": REQUESTS_TENSORFRAME.get_value(),
        "wire_bytes_json": WIRE_BYTES_JSON.get_value(),
        "wire_bytes_tensorframe": WIRE_BYTES_TENSORFRAME.get_value(),
    }


class PSService(Service):
    NAME = "PS"

    def __init__(self, shard: EmbeddingShardServer,
                 lookup_batcher=None, update_batcher=None,
                 update_record_batcher=None):
        self.shard = shard
        self._lookup_b = lookup_batcher
        self._update_b = update_batcher
        # the BINARY update path's batcher (uint8 records, no float64
        # packing); None falls back to direct per-request apply
        self._update_tb = update_record_batcher

    @staticmethod
    def _count_wire(cntl, binary: bool) -> None:
        n = int(getattr(cntl, "request_body_size", 0) or 0)
        if binary:
            REQUESTS_TENSORFRAME.add(1)
            WIRE_BYTES_TENSORFRAME.add(n)
        else:
            REQUESTS_JSON.add(1)
            WIRE_BYTES_JSON.add(n)

    @staticmethod
    def _claim_bypass(b) -> bool:
        """Idle bypass: with an EAGER batcher that has no
        queue and no batch in flight, this request would execute alone
        anyway — serve it straight on the handler thread and skip the
        defer/enqueue/scatter bookkeeping entirely (~300us on CPU
        loopback).  The claim (``DynamicBatcher.try_claim_idle``) holds
        the batcher's execution slot, so concurrent arrivals queue and
        coalesce behind the bypassed request; brownout refuses the
        claim so degraded batchers keep their shed policy."""
        return b is not None and b.try_claim_idle()

    @staticmethod
    def _release_bypass(b) -> None:
        b.release_idle()

    # ---- the fused co-located optimizer apply ----
    #
    # An optimizer-carrying Update takes the DIRECT path: the wave is
    # already trainer-batched (one RPC per partition per step), its
    # semantics (slot step per touched row) can't coalesce with plain
    # scatter-adds in a batcher row, and the apply is one fused call
    # either way.  Same lock, same version counter, same
    # applied-id dedup set as every other update — a retry on EITHER
    # wire acks the original apply and steps nothing.

    def _apply_opt(self, cntl, keys, grads, uid, spec):
        if fault.ENABLED and fault.hit(
                fault.PS_OPT_APPLY, shard=self.shard.shard_index,
                stage="pre") is not None:
            # pre-apply: no slot stepped, no row written; a retried
            # wave applies normally
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.opt_apply fault "
                            "(pre-apply)")
            return None
        try:
            ver, dup = self.shard.update_opt(keys, grads, spec,
                                             update_id=uid)
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        if fault.ENABLED and fault.hit(
                fault.PS_OPT_APPLY, shard=self.shard.shard_index,
                stage="post") is not None:
            # post-apply ack drop: momentum DID step; the retried wave
            # must dedup by update_id or the slot double-steps
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.opt_apply fault "
                            "(post-apply)")
            return None
        return {"version": int(ver), "duplicate": bool(dup)}

    # ---- Lookup ----

    @method(request="json", response="json")
    def Lookup(self, cntl, req):
        self._count_wire(cntl, binary=False)
        keys = (req or {}).get("keys")
        if keys is None:
            cntl.set_failed(errors.EREQUEST, 'missing "keys"')
            return None
        if fault.ENABLED and fault.hit(
                fault.PS_LOOKUP, shard=self.shard.shard_index,
                n_keys=len(keys)) is not None:
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.lookup fault")
            return None
        try:
            local = self.shard._to_local(np.asarray(keys, np.int64))
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        b = self._lookup_b
        claimed = self._claim_bypass(b)
        if b is None or claimed:
            try:
                try:
                    rows, ver = self.shard.lookup(keys)  # counts + hot
                except ValueError as e:
                    # e.g. a key-set larger than the biggest bucket: a
                    # deterministic bad request, never EINTERNAL
                    cntl.set_failed(errors.EREQUEST, str(e))
                    return None
                return {"rows": rows.tolist(), "version": ver}
            finally:
                if claimed:
                    self._release_bypass(b)

        shard = self.shard

        def transform(row):
            # row: [n_keys, D] trimmed by the batcher's padded-output
            # scatter; version read at COMPLETION so any update acked
            # before this lookup's batch executed is covered.  Hot-key
            # and counter accounting happens HERE — only lookups that
            # were actually served shape the histogram (a shed/ELIMIT
            # reject never runs the transform), matching the unbatched
            # path
            shard._note_hot(local)
            with shard._mu:
                ver = shard.version
                shard.n_lookups += 1
            LOOKUPS.add(1)
            LOOKUP_KEYS.add(int(row.shape[0]))
            return {"rows": np.asarray(row).tolist(), "version": ver}

        self._lookup_b.submit(cntl, local, transform=transform)
        return None     # deferred: the batch drainer completes the RPC

    # ---- Update ----

    @method(request="json", response="json")
    def Update(self, cntl, req):
        self._count_wire(cntl, binary=False)
        req = req or {}
        keys = req.get("keys")
        grads = req.get("grads")
        uid = req.get("update_id")
        if keys is None or grads is None:
            cntl.set_failed(errors.EREQUEST, 'missing "keys"/"grads"')
            return None
        # the batched apply packs ids into float64 rows and uses 0 as
        # the padding sentinel — an id outside (0, 2^53] would be
        # silently discarded (acked but never applied) or rounded onto
        # another id; ONE validation shared with the binary wire
        ok, uid, msg = _coerce_uid(uid)
        if not ok:
            cntl.set_failed(errors.EREQUEST, msg)
            return None
        spec = None
        if req.get("optimizer") is not None:
            try:
                spec = OptimizerSpec.from_wire(req["optimizer"])
            except ValueError as e:
                cntl.set_failed(errors.EREQUEST, str(e))
                return None
        if fault.ENABLED and fault.hit(
                fault.PS_UPDATE, shard=self.shard.shard_index,
                stage="pre") is not None:
            # pre-apply failure: nothing was written; a retry applies
            # normally
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.update fault (pre-apply)")
            return None
        try:
            local = self.shard._to_local(np.asarray(keys, np.int64))
            g = np.asarray(grads, np.float32)
            if g.shape != (local.shape[0], self.shard.dim):
                raise ValueError(f"grads shape {g.shape} != "
                                 f"({local.shape[0]}, {self.shard.dim})")
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        if spec is not None:
            return self._apply_opt(cntl, keys, g, uid, spec)

        def ack(ver: int, dup: bool):
            if fault.ENABLED and fault.hit(
                    fault.PS_UPDATE, shard=self.shard.shard_index,
                    stage="post") is not None:
                # post-apply ack drop: the update IS in the table; the
                # client's retry must be deduped by update_id or the
                # scatter-add doubles
                raise RuntimeError(
                    "injected psserve.update fault (post-apply)")
            return {"version": int(ver), "duplicate": bool(dup)}

        b = self._update_b
        claimed = False
        if b is not None and uid is not None:
            claimed = self._claim_bypass(b)
        if b is None or uid is None or claimed:
            try:
                try:
                    ver, dup = self.shard.update(keys, grads,
                                                 update_id=uid)
                except ValueError as e:
                    # oversize key-set etc.: deterministic bad request
                    cntl.set_failed(errors.EREQUEST, str(e))
                    return None
                try:
                    return ack(ver, dup)
                except RuntimeError as e:
                    cntl.set_failed(errors.EINTERNAL, str(e))
                    return None
            finally:
                if claimed:
                    self._release_bypass(b)
        row = EmbeddingShardServer.pack_update(int(uid), local, g)
        n_keys = int(local.shape[0])

        def transform(a):
            # a raising transform completes the RPC with EINTERNAL —
            # the post-apply ack-drop path above rides that contract.
            # UPDATE_KEYS counts here (the batch fn can't recover live
            # key counts from zero-padded rows), applied rows only
            if not bool(a[1]):
                UPDATE_KEYS.add(n_keys)
            return ack(int(a[0]), bool(a[1]))

        self._update_b.submit(cntl, row, transform=transform)
        return None

    # ---- the binary tensor wire (tensorframe) ----
    #
    # Same semantics as Lookup/Update — same fault sites, same dedup
    # set, same batchers' bucket discipline — but the request arrives
    # as a tensorframe whose tensors are ZERO-COPY views over the
    # transport body, and batches form directly from those views: the
    # lookup batcher takes the int64 key view as-is, and updates pack
    # byte records (pack_update_record) instead of the float64
    # 1+k*(1+D) rows.  A client that calls LookupT/UpdateT on an old
    # server gets ENOMETHOD and falls back to JSON per channel
    # (PSClient negotiation).

    @method(request="tensorframe", response="tensorframe")
    def LookupT(self, cntl, req):
        self._count_wire(cntl, binary=True)
        keys = (req or {}).get("keys")
        if keys is None or not isinstance(keys, np.ndarray) \
                or keys.dtype != np.int64 or keys.ndim != 1:
            cntl.set_failed(errors.EREQUEST,
                            'need int64[n] tensor field "keys"')
            return None
        if fault.ENABLED and fault.hit(
                fault.PS_LOOKUP, shard=self.shard.shard_index,
                n_keys=len(keys)) is not None:
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.lookup fault")
            return None
        try:
            local = self.shard._to_local(keys)
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        b = self._lookup_b
        claimed = self._claim_bypass(b)
        if b is None or claimed:
            try:
                try:
                    rows, ver = self.shard.lookup(keys)
                except ValueError as e:
                    cntl.set_failed(errors.EREQUEST, str(e))
                    return None
                return {"rows": rows, "version": ver}
            finally:
                if claimed:
                    self._release_bypass(b)

        shard = self.shard

        def transform(row):
            # identical accounting to the JSON transform; the response
            # rows ride out as raw float32 bytes, never a list
            shard._note_hot(local)
            with shard._mu:
                ver = shard.version
                shard.n_lookups += 1
            LOOKUPS.add(1)
            LOOKUP_KEYS.add(int(row.shape[0]))
            return {"rows": np.asarray(row), "version": ver}

        self._lookup_b.submit(cntl, local, transform=transform)
        return None

    @method(request="tensorframe", response="tensorframe")
    def UpdateT(self, cntl, req):
        self._count_wire(cntl, binary=True)
        req = req or {}
        keys = req.get("keys")
        grads = req.get("grads")
        uid = req.get("update_id")
        if keys is None or grads is None \
                or not isinstance(keys, np.ndarray) \
                or not isinstance(grads, np.ndarray) \
                or keys.dtype != np.int64 or keys.ndim != 1 \
                or grads.dtype != np.float32:
            cntl.set_failed(errors.EREQUEST,
                            'need int64[n] "keys" + float32[n,D] '
                            '"grads" tensor fields')
            return None
        # the SAME validation as the JSON path: dedup is one applied
        # set, and a retry may cross wire formats after a negotiation
        # fallback — accept/reject must not differ between wires
        ok, uid, msg = _coerce_uid(uid)
        if not ok:
            cntl.set_failed(errors.EREQUEST, msg)
            return None
        # the binary wire's optimizer spec rides as FLATTENED inline
        # fields (opt_kind + opt_* floats — tensorframe has no nested
        # dicts); same validation → EREQUEST contract as JSON
        try:
            spec = OptimizerSpec.from_frame_fields(req)
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        if fault.ENABLED and fault.hit(
                fault.PS_UPDATE, shard=self.shard.shard_index,
                stage="pre") is not None:
            cntl.set_failed(errors.EINTERNAL,
                            "injected psserve.update fault (pre-apply)")
            return None
        try:
            local = self.shard._to_local(keys)
            if grads.shape != (local.shape[0], self.shard.dim):
                raise ValueError(f"grads shape {grads.shape} != "
                                 f"({local.shape[0]}, {self.shard.dim})")
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        if spec is not None:
            return self._apply_opt(cntl, keys, grads, uid, spec)

        def ack(ver: int, dup: bool):
            if fault.ENABLED and fault.hit(
                    fault.PS_UPDATE, shard=self.shard.shard_index,
                    stage="post") is not None:
                raise RuntimeError(
                    "injected psserve.update fault (post-apply)")
            return {"version": int(ver), "duplicate": bool(dup)}

        b = self._update_tb
        claimed = False
        if b is not None and uid is not None:
            claimed = self._claim_bypass(b)
        if b is None or uid is None or claimed:
            try:
                try:
                    ver, dup = self.shard.update(keys, grads,
                                                 update_id=uid)
                except ValueError as e:
                    cntl.set_failed(errors.EREQUEST, str(e))
                    return None
                try:
                    return ack(ver, dup)
                except RuntimeError as e:
                    cntl.set_failed(errors.EINTERNAL, str(e))
                    return None
            finally:
                if claimed:
                    self._release_bypass(b)
        rec = EmbeddingShardServer.pack_update_record(int(uid), local,
                                                     grads)
        n_keys = int(local.shape[0])

        def transform(a):
            if not bool(a[1]):
                UPDATE_KEYS.add(n_keys)
            return ack(int(a[0]), bool(a[1]))

        self._update_tb.submit(cntl, rec, transform=transform)
        return None

    # ---- dense params ----

    @method(request="json", response="json")
    def Pull(self, cntl, req):
        pname = (req or {}).get("name")
        if not pname:
            cntl.set_failed(errors.EREQUEST, 'missing "name"')
            return None
        try:
            v = self.shard.pull(pname)
        except KeyError:
            cntl.set_failed(errors.ENODATA, f"no dense param {pname!r}")
            return None
        return {"name": pname, "value": v.tolist(),
                "shape": list(v.shape)}

    @method(request="json", response="json")
    def Push(self, cntl, req):
        req = req or {}
        pname = req.get("name")
        delta = req.get("delta")
        if not pname or delta is None:
            cntl.set_failed(errors.EREQUEST, 'missing "name"/"delta"')
            return None
        try:
            ver, dup = self.shard.push(pname, delta,
                                       update_id=req.get("update_id"))
        except ValueError as e:
            cntl.set_failed(errors.EREQUEST, str(e))
            return None
        return {"version": int(ver), "duplicate": bool(dup)}

    @method(request="json", response="json")
    def Stats(self, cntl, req):
        return self.shard.stats()


def register_psserve(server, shard: EmbeddingShardServer, *,
                     batch: bool = True, max_batch_size: int = 16,
                     max_delay_us: int = 1000, eager: bool = True,
                     name: Optional[str] = None):
    """Expose one shard on an rpc Server; returns the PSService (its
    batchers close with ``unregister_psserve``).

    The PS batchers default to EAGER mode: an idle arrival
    cuts through inline (no window, no cross-thread hop) and batches
    form from whatever accumulated while the previous batch executed —
    small-request embedding traffic is latency-sensitive, and the
    batching window was measured costing ~1ms per request of pure idle
    latency on CPU loopback.  ``eager=False`` restores the windowed
    ``max_delay_us`` policy."""
    from .. import psserve as _ps
    lookup_b = update_b = update_tb = None
    safe = name or f"{shard.name}_{shard.shard_index}"
    if batch:
        lookup_b = DynamicBatcher(
            shard.lookup_batch_fn,
            max_batch_size=max_batch_size, max_delay_us=max_delay_us,
            length_buckets=shard.key_buckets,
            dtype=np.int64, padded_output=True, eager=eager,
            name=f"ps_lookup_{safe}")
        update_b = DynamicBatcher(
            shard.update_batch_fn,
            max_batch_size=max_batch_size, max_delay_us=max_delay_us,
            length_buckets=shard.update_length_buckets(),
            dtype=np.float64, padded_output=False, eager=eager,
            name=f"ps_update_{safe}")
        # the binary wire's update batcher: uint8 records, byte-length
        # buckets — coalesces UpdateT exactly like Update, against the
        # same shard lock and applied set
        update_tb = DynamicBatcher(
            shard.update_batch_fn_binary,
            max_batch_size=max_batch_size, max_delay_us=max_delay_us,
            length_buckets=shard.update_record_buckets(),
            dtype=np.uint8, padded_output=False, eager=eager,
            name=f"ps_updatet_{safe}")
    svc = PSService(shard, lookup_batcher=lookup_b,
                    update_batcher=update_b,
                    update_record_batcher=update_tb)
    server.add_service(svc)
    _ps._register_shard(shard, svc)
    return svc


def unregister_psserve(svc: PSService) -> None:
    """Close the service's batchers (flushes queued batches)."""
    for b in (svc._lookup_b, svc._update_b, svc._update_tb):
        if b is not None:
            b.close()
