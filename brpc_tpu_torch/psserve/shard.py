"""EmbeddingShardServer: one partition of a sharded embedding table (the
port of ``brpc_tpu/psserve/shard.py``).

The ownership map is contiguous row ranges (:func:`shard_bounds`): shard
i of n owns global rows ``[lo, hi)``.  A shard answers

  * ``Lookup(keys) -> rows``: gather of OWNED rows (the client routed
    the keys; duplicates are legal and each occurrence is served),
  * ``Update(keys, grads)``: sparse scatter-add into the owned rows,
    idempotent by ``update_id`` so a retried sub-call (lost ack, an
    injected fault mid-fan-out) can never double-apply,
  * ``Pull/Push(name)``: dense whole-parameter read / delta-add for the
    rest of the model (owner chosen by name hash, client-side).

Every applied update advances the shard's VERSION counter and every
lookup response carries it: an Update acked at version v is visible to
any Lookup issued afterwards, the read-your-writes contract the client
checks.

The rows (and the optimizer slots) are tensors on the shard's device
(``cuda`` unless the caller passes ``device="cpu"``): the gather is
tensor indexing, the scatter ``index_add_``, the optimizer apply the
in-place fused program of ``train/optimizer.py``.  Key counts are still
checked against ``key_buckets``: a key set larger than the largest
bucket is a bad request, as in the reference, which pads to them.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder
from ..device import resolve_device
from ..train.optimizer import fused_apply

DEFAULT_KEY_BUCKETS = (8, 32, 128, 512)

# process-wide counters (per-shard numbers live on the instance)
LOOKUPS = Adder("psserve_lookups")
LOOKUP_KEYS = Adder("psserve_lookup_keys")
UPDATES = Adder("psserve_updates")
UPDATE_KEYS = Adder("psserve_update_keys")
DUP_UPDATES = Adder("psserve_dup_updates")
OPT_UPDATES = Adder("psserve_opt_updates")
PULLS = Adder("psserve_pulls")
PUSHES = Adder("psserve_pushes")


def shard_bounds(vocab: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous ownership ranges: shard i owns rows [lo, hi).  The
    remainder spreads over the FIRST shards so every shard's size
    differs by at most one row."""
    if n_shards < 1 or vocab < n_shards:
        raise ValueError(f"need 1 <= n_shards <= vocab, got "
                         f"{n_shards}/{vocab}")
    base, rem = divmod(vocab, n_shards)
    bounds = []
    lo = 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def owners_for(keys: np.ndarray, bounds: Sequence[tuple[int, int]]
               ) -> np.ndarray:
    """Owning shard index per key (vectorized over the range table)."""
    los = np.asarray([b[0] for b in bounds])
    return (np.searchsorted(los, np.asarray(keys), side="right") - 1
            ).astype(np.int64)


def init_embedding_table(vocab: int, dim: int, seed: int = 0) -> np.ndarray:
    """The deterministic full table every shard slices its rows from,
    the same bytes as the reference's for a seed; also the oracle's
    starting point."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((vocab, dim)) * 0.02).astype(np.float32)


def _bucket_up(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} keys exceed largest bucket {buckets[-1]}")


class EmbeddingShardServer:
    """One partition's state: rows and optimizer slots on the device,
    the version counter and the applied-id ledger on the host."""

    def __init__(self, shard_index: int, n_shards: int, vocab: int,
                 dim: int, *, seed: int = 0,
                 table: Optional[np.ndarray] = None,
                 dense_params: Optional[dict] = None,
                 mesh=None,
                 key_buckets: Sequence[int] = DEFAULT_KEY_BUCKETS,
                 applied_cap: int = 65536,
                 name: str = "ps", device=None):
        if mesh is not None:
            raise ValueError("mesh= (rows sharded again over a device "
                             "mesh) is not ported yet: ROADMAP Queue 1 "
                             "item 9, the mesh slice")
        self.device = resolve_device(device)
        self.shard_index = int(shard_index)
        self.n_shards = int(n_shards)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.name = name
        self.key_buckets = tuple(sorted(key_buckets))
        self.bounds = shard_bounds(vocab, n_shards)
        self.lo, self.hi = self.bounds[self.shard_index]
        full = table if table is not None else \
            init_embedding_table(vocab, dim, seed)
        rows = np.array(full[self.lo:self.hi], dtype=np.float32)
        self._rows = torch.from_numpy(rows).to(self.device)
        # dense parameters (the non-embedding rest of the model); the
        # CLIENT routes each name to its owner shard by hash
        self._dense: dict[str, np.ndarray] = {
            k: np.asarray(v, np.float32)
            for k, v in (dense_params or {}).items()}
        # Lock discipline: the fused optimizer apply and the scatter
        # write the rows and slots IN PLACE, so every read of them
        # completes under this lock -- a gather's host copy included --
        # and snapshots hand out copies
        self._mu = InstrumentedLock("psserve.shard_apply",
                                    threading.RLock())
        self.version = 0
        self._applied: OrderedDict[int, int] = OrderedDict()  # uid -> ver
        self._applied_cap = int(applied_cap)
        # co-located optimizer slots: per-row momentum / Adam m/v/step,
        # allocated at the first optimizer-carrying update, on the
        # rows' device, never on the wire
        self._slots: dict = {}
        self.n_lookups = 0
        self.n_updates = 0
        self.n_opt_updates = 0
        self.n_dup_updates = 0
        self.n_pulls = 0
        self.n_pushes = 0
        # hot-key histogram (bounded: prune to the top half at 4096)
        self._hot: dict[int, int] = {}

    # ---- ownership helpers ----

    @property
    def n_rows(self) -> int:
        return self.hi - self.lo

    def owns(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        return (keys >= self.lo) & (keys < self.hi)

    def _to_local(self, keys) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size and (keys.min() < self.lo or keys.max() >= self.hi):
            raise ValueError(
                f"shard {self.shard_index} owns [{self.lo},{self.hi}), "
                f"got keys outside the range")
        return keys - self.lo

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:   # a zero-copy view of a request body
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _gather_locked(self, local: np.ndarray) -> np.ndarray:
        """Rows at ``local`` as a fresh host array (call under _mu)."""
        return self._rows[self._dev(local)].cpu().numpy()

    def _note_hot(self, local_keys: np.ndarray) -> None:
        uniq, counts = np.unique(local_keys, return_counts=True)
        with self._mu:      # RLock: callers inside the lock re-enter
            hot = self._hot
            for k, c in zip(uniq.tolist(), counts.tolist()):
                hot[k + self.lo] = hot.get(k + self.lo, 0) + c
            if len(hot) > 4096:
                keep = sorted(hot.items(), key=lambda kv: -kv[1])[:2048]
                self._hot = dict(keep)

    # ---- direct (unbatched) entry points ----

    def lookup(self, keys) -> tuple[np.ndarray, int]:
        """Gather owned rows for GLOBAL keys; returns (rows [n, dim],
        shard version at serve time)."""
        local = self._to_local(keys)
        n = local.shape[0]
        _bucket_up(max(n, 1), self.key_buckets)
        with self._mu:
            rows = self._gather_locked(local)
            ver = self.version
            self.n_lookups += 1
            self._note_hot(local)
        LOOKUPS.add(1)
        LOOKUP_KEYS.add(int(n))
        return rows, ver

    def update(self, keys, grads, update_id: Optional[int] = None
               ) -> tuple[int, bool]:
        """Sparse scatter-add for GLOBAL keys; returns (version after
        the apply, was_duplicate).  A duplicate ``update_id`` acks with
        the ORIGINAL apply's version and touches nothing."""
        local = self._to_local(keys)
        grads = np.asarray(grads, np.float32)
        if grads.shape != (local.shape[0], self.dim):
            raise ValueError(f"grads shape {grads.shape} != "
                             f"({local.shape[0]}, {self.dim})")
        _bucket_up(max(local.shape[0], 1), self.key_buckets)
        with self._mu:
            if update_id is not None and update_id in self._applied:
                self.n_dup_updates += 1
                DUP_UPDATES.add(1)
                return self._applied[update_id], True
            self._rows.index_add_(0, self._dev(local), self._dev(grads))
            self.version += 1
            ver = self.version
            if update_id is not None:
                self._record_applied_locked(update_id, ver)
            self.n_updates += 1
        UPDATES.add(1)
        UPDATE_KEYS.add(int(local.shape[0]))
        return ver, False

    # ---- the fused co-located optimizer apply ----

    def _ensure_slots_locked(self, spec) -> None:
        if "m" not in self._slots:
            self._slots["m"] = torch.zeros_like(self._rows)
        if spec.kind == "adam":
            if "v" not in self._slots:
                self._slots["v"] = torch.zeros_like(self._rows)
            if "t" not in self._slots:
                self._slots["t"] = torch.zeros(
                    (self.n_rows,), dtype=torch.float32,
                    device=self.device)

    def update_opt(self, keys, grads, spec,
                   update_id: Optional[int] = None) -> tuple[int, bool]:
        """``update`` with co-located optimizer state: the gradient
        scatter AND the slot step run as ONE fused apply on the shard's
        device, in place, under the same lock, version counter and
        applied-id dedup as the plain scatter-add, so a retried wave
        acks the ORIGINAL version and never double-steps momentum.  The
        client sends RAW gradients; the slot rows never cross the
        wire."""
        local = self._to_local(keys)
        grads = np.asarray(grads, np.float32)
        if grads.shape != (local.shape[0], self.dim):
            raise ValueError(f"grads shape {grads.shape} != "
                             f"({local.shape[0]}, {self.dim})")
        fn = fused_apply(spec.kind)
        n = local.shape[0]
        b = _bucket_up(max(n, 1), self.key_buckets)
        pk = np.zeros((b,), np.int64)
        pg = np.zeros((b, self.dim), np.float32)
        # padding entries carry valid=0: they add no gradient AND do
        # not mark row 0 touched (a zero-grad pad alone would still
        # decay row 0's momentum)
        pv = np.zeros((b,), np.float32)
        pk[:n] = local
        pg[:n] = grads
        pv[:n] = 1.0
        k, g, v = self._dev(pk), self._dev(pg), self._dev(pv)
        with self._mu:
            if update_id is not None and update_id in self._applied:
                self.n_dup_updates += 1
                DUP_UPDATES.add(1)
                return self._applied[update_id], True
            self._ensure_slots_locked(spec)
            s = self._slots
            if spec.kind == "sgdm":
                fn(self._rows, s["m"], k, g, v, spec.lr, spec.momentum)
            else:
                fn(self._rows, s["m"], s["v"], s["t"], k, g, v,
                   spec.lr, spec.beta1, spec.beta2, spec.eps)
            self.version += 1
            ver = self.version
            if update_id is not None:
                self._record_applied_locked(update_id, ver)
            self.n_updates += 1
            self.n_opt_updates += 1
            # no _note_hot here: key heat means READ traffic, and a
            # trainer hammering its own rows must not look like it
        UPDATES.add(1)
        OPT_UPDATES.add(1)
        UPDATE_KEYS.add(int(n))
        return ver, False

    def snapshot_slots(self) -> dict:
        """Current optimizer slot tables as numpy copies."""
        with self._mu:
            return {k: v.cpu().numpy().copy()
                    for k, v in self._slots.items()}

    def _record_applied_locked(self, uid: int, ver: int) -> None:
        self._applied[uid] = ver
        while len(self._applied) > self._applied_cap:
            self._applied.popitem(last=False)

    # ---- dense Pull/Push ----

    def pull(self, pname: str) -> np.ndarray:
        with self._mu:
            if pname not in self._dense:
                raise KeyError(pname)
            self.n_pulls += 1
            out = self._dense[pname].copy()
        PULLS.add(1)
        return out

    def push(self, pname: str, delta, update_id: Optional[int] = None,
             ) -> tuple[int, bool]:
        delta = np.asarray(delta, np.float32)
        with self._mu:
            if update_id is not None and update_id in self._applied:
                self.n_dup_updates += 1
                DUP_UPDATES.add(1)
                return self._applied[update_id], True
            cur = self._dense.get(pname)
            if cur is None:
                self._dense[pname] = delta.copy()
            else:
                if cur.shape != delta.shape:
                    raise ValueError(f"push {pname}: shape {delta.shape} "
                                     f"!= {cur.shape}")
                self._dense[pname] = cur + delta
            self.version += 1
            ver = self.version
            if update_id is not None:
                self._record_applied_locked(update_id, ver)
            self.n_pushes += 1
        PUSHES.add(1)
        return ver, False

    # ---- DynamicBatcher batch_fns (service.py wires these) ----
    #
    # Lookup rows are int64 key vectors; the batch gather is ONE
    # [B, Lb] -> [B, Lb, D] index (padded key 0 gathers row 0 and is
    # trimmed away by the batcher's padded-output scatter).

    def lookup_batch_fn(self, padded: np.ndarray) -> np.ndarray:
        # per-request accounting (live-row counts, hot keys) happens in
        # the service handler: this fn sees bucket-padded rows
        k = np.asarray(padded, np.int64)
        with self._mu:
            return self._gather_locked(k)

    # Update rows pack (update_id, then per key [key, grad...]) into ONE
    # float64 vector: [uid, k0, g0_0..g0_{D-1}, k1, g1_0..].  float64
    # carries 53-bit update ids and float32 grads exactly; the length
    # buckets are 1 + k*(1+D) so the padded batch reshapes to
    # [B, kb, 1+D] (zero rows scatter grad 0 into row 0: a no-op).
    # Dedup is decided here, at APPLY time under the shard lock.

    def update_length_buckets(self) -> tuple:
        return tuple(1 + k * (1 + self.dim) for k in self.key_buckets)

    @staticmethod
    def pack_update(update_id: int, local_keys: np.ndarray,
                    grads: np.ndarray) -> np.ndarray:
        n, d = grads.shape
        row = np.empty((1 + n * (1 + d),), np.float64)
        row[0] = float(update_id)
        body = row[1:].reshape(n, 1 + d)
        body[:, 0] = local_keys
        body[:, 1:] = grads
        return row

    def update_batch_fn(self, padded: np.ndarray) -> np.ndarray:
        """One coalesced scatter-add for every update row in the batch;
        returns per-row [version, dup_flag] acks."""
        B, Lb = padded.shape
        kb = (Lb - 1) // (1 + self.dim)
        body = np.ascontiguousarray(
            padded[:, 1:1 + kb * (1 + self.dim)]
        ).reshape(B, kb, 1 + self.dim)
        keys = body[:, :, 0].astype(np.int64)
        grads = body[:, :, 1:].astype(np.float32)
        uids = padded[:, 0].astype(np.int64)
        return self._apply_update_batch(uids, keys, grads)

    # The BINARY update path (tensorframe wire) packs bytes, not
    # float64: one record is [update_id u64][key i64, grad f32*D] x k.
    # Padding bytes are zero = key 0 grad 0 groups, a scatter no-op;
    # both paths share _apply_update_batch, so dedup is decided against
    # ONE applied set whichever wire a retry arrives on.

    def update_record_buckets(self) -> tuple:
        return tuple(8 + k * (8 + 4 * self.dim) for k in self.key_buckets)

    @staticmethod
    def pack_update_record(update_id: int, local_keys: np.ndarray,
                           grads: np.ndarray) -> np.ndarray:
        """One uint8 record from int64 keys + float32 grads."""
        n, d = grads.shape
        rec = np.empty((8 + n * (8 + 4 * d),), np.uint8)
        rec[:8] = np.frombuffer(struct.pack("<Q", update_id), np.uint8)
        body = rec[8:].reshape(n, 8 + 4 * d)
        body[:, :8] = np.ascontiguousarray(
            local_keys, "<i8").view(np.uint8).reshape(n, 8)
        body[:, 8:] = np.ascontiguousarray(
            grads, "<f4").view(np.uint8).reshape(n, 4 * d)
        return rec

    def update_batch_fn_binary(self, padded: np.ndarray) -> np.ndarray:
        """update_batch_fn for uint8 records: reinterpret the byte
        columns as (uids, keys, grads), then the shared apply."""
        B, Lb = padded.shape
        kb = (Lb - 8) // (8 + 4 * self.dim)
        uids = np.ascontiguousarray(
            padded[:, :8]).view("<u8").reshape(B).astype(np.int64)
        body = np.ascontiguousarray(
            padded[:, 8:8 + kb * (8 + 4 * self.dim)]
        ).reshape(B, kb, 8 + 4 * self.dim)
        keys = np.ascontiguousarray(
            body[:, :, :8]).view("<i8").reshape(B, kb)
        grads = np.ascontiguousarray(
            body[:, :, 8:]).view("<f4").reshape(B, kb, self.dim)
        return self._apply_update_batch(uids, keys, grads)

    def _apply_update_batch(self, uids: np.ndarray, keys: np.ndarray,
                            grads: np.ndarray) -> np.ndarray:
        """The ONE coalesced apply both wire formats feed: per-row
        dedup (applied set + intra-batch), one scatter, acks
        [version, dup_flag] per row.  uid 0 marks batch padding."""
        B = keys.shape[0]
        acks = np.zeros((B, 2), np.float64)
        with self._mu:
            # dedup against the applied set AND within this batch: a
            # retry can land in the SAME batch as its original (reply
            # lost before the batch formed)
            first_row: dict[int, int] = {}
            batch_dups: list[tuple[int, int]] = []   # (row, first row)
            for i in range(B):
                uid = int(uids[i])
                if uid == 0:
                    continue            # batch padding, not a request
                if uid in self._applied:
                    self.n_dup_updates += 1
                    DUP_UPDATES.add(1)
                    acks[i] = (self._applied[uid], 1.0)
                    # zero the row out of the scatter: served from the
                    # applied set, never re-added
                    keys[i] = 0
                    grads[i] = 0.0
                    continue
                if uid in first_row:
                    batch_dups.append((i, first_row[uid]))
                    keys[i] = 0
                    grads[i] = 0.0
                    continue
                first_row[uid] = i
            self._rows.index_add_(0, self._dev(keys.reshape(-1)),
                                  self._dev(grads.reshape(-1, self.dim)))
            for uid, i in first_row.items():
                self.version += 1
                self._record_applied_locked(uid, self.version)
                acks[i] = (self.version, 0.0)
                self.n_updates += 1
                UPDATES.add(1)
            for i, j in batch_dups:
                # ack the retry with the ORIGINAL apply's version
                self.n_dup_updates += 1
                DUP_UPDATES.add(1)
                acks[i] = (acks[j, 0], 1.0)
        return acks

    # ---- introspection ----

    def hot_keys(self, top: int = 10) -> list[tuple[int, int]]:
        with self._mu:
            return sorted(self._hot.items(), key=lambda kv: -kv[1])[:top]

    def stats(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "shard_index": self.shard_index,
                "n_shards": self.n_shards,
                "rows": self.n_rows,
                "range": [self.lo, self.hi],
                "dim": self.dim,
                "device": str(self.device),
                "version": self.version,
                "lookups": self.n_lookups,
                "updates": self.n_updates,
                "opt_updates": self.n_opt_updates,
                "opt_slots": sorted(self._slots),
                "dup_updates": self.n_dup_updates,
                "pulls": self.n_pulls,
                "pushes": self.n_pushes,
                "dense_params": sorted(self._dense),
                "applied_ids": len(self._applied),
                "hot_keys": self.hot_keys(),
            }

    def snapshot_rows(self) -> np.ndarray:
        """The shard's current rows as a numpy copy."""
        with self._mu:
            return self._rows.cpu().numpy().copy()
