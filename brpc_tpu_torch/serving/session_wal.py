"""Session write-ahead log: the durable half of the router's control
plane (a copy of ``brpc_tpu/serving/session_wal.py``, the same record
format: a WAL written by either package recovers in the other).

A :class:`~brpc_tpu_torch.serving.router.SessionTable` survives a router
OBJECT restart because it is caller-owned; this log makes it survive a
router PROCESS death:

  * every session mutation -- ``open`` (create), ``tok`` (one cursor
    advance), ``fin`` (terminal), ``ep`` (membership epoch) -- is
    appended as one checksummed :mod:`~brpc_tpu_torch.butil.recordio`
    record and flushed BEFORE the token reaches any client sink, so a
    successor replaying the WAL is never BEHIND a cursor some client
    will present (flush to the OS covers process death; ``fsync=True``
    covers machine death too);
  * an append failure (disk error, ``fault.ROUTER_WAL_APPEND``) never
    touches the token path: the record parks on a pending tail that
    heals by riding the next successful append, order preserved.  A
    crash inside the gap degrades that session to recompute-on-resume:
    the successor's record is shorter than the client's cursor, the
    session re-decodes the missing tail and delivery is suppressed up to
    the cursor -- never a duplicate token;
  * COMPACTION is bounded and runs in the background: past
    ``compact_bytes``/``compact_min_records``, a snapshot of the live
    table (one ``snap`` record per session, from ``snapshot_source``)
    replaces the history through an atomic rename, so replay costs the
    table's size, not every token ever decoded;
  * OPENING IS RECOVERING: the constructor replays whatever the path
    holds (corrupt records skipped by recordio's resync, a torn tail
    loses only itself) into ``recovered`` and the ``replay`` stats, and
    ``SessionTable.recover(path)`` turns them into live sessions.  The
    largest ``ep`` record is the fleet's membership epoch; a successor
    bumps it so replicas fence floor pushes from the superseded router
    (``serving/cluster_control.py``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from .. import fault
from ..butil.lockprof import InstrumentedLock
from ..butil.recordio import RecordReader, RecordWriter
from ..serving.modelplane import DEFAULT_MODEL

# record type tags (recordio meta field)
REC_OPEN = b"open"
REC_TOK = b"tok"
REC_FIN = b"fin"
REC_SNAP = b"snap"
REC_EPOCH = b"ep"


class SessionWAL:
    """Write-ahead log for one SessionTable (see module docstring).

    ``recovered`` holds ``{sid: {"prompt", "budget", "emitted",
    "state", "error_code", "model"}}`` replayed from the path at open;
    ``SessionTable.recover`` consumes (and clears) it.  All ``append_*``
    methods are non-raising: failures park on the pending tail and are
    counted, because the WAL must never break the token path it
    guards."""

    def __init__(self, path, *, compact_bytes: int = 1 << 20,
                 compact_min_records: int = 2048, fsync: bool = False,
                 auto_compact: bool = True):
        self.path = str(path)
        self.compact_bytes = int(compact_bytes)
        self.compact_min_records = int(compact_min_records)
        self.fsync = bool(fsync)
        self._mu = InstrumentedLock("router.wal")
        # snapshot provider for compaction — set by the owning
        # SessionTable (returns the session dicts a snap record holds)
        self.snapshot_source: Optional[Callable[[], list]] = None

        self.epoch = 0
        self.records = 0            # records in the file right now
        self.appends = 0
        self.append_failures = 0
        self.healed_records = 0     # pending-tail records later durably written
        self.compactions = 0
        self.last_compaction: Optional[dict] = None
        self._pending: deque = deque()   # (meta, body) not yet durable

        self.recovered: dict[str, dict] = {}
        self.replay = self._replay()

        self._fp = open(self.path, "ab")
        self._writer = RecordWriter(self._fp)

        self._closed = False
        self._compact_cv = threading.Condition(self._mu)
        self._compact_thread: Optional[threading.Thread] = None
        if auto_compact:
            t = threading.Thread(target=self._compact_loop, daemon=True,
                                 name="session-wal-compact")
            t.start()
            self._compact_thread = t

    # ---- replay (open IS recover) ----

    def _replay(self) -> dict:
        t0 = time.monotonic()
        stats = {"records": 0, "sessions": 0, "orphan_tok": 0,
                 "gap_tok": 0, "epoch": 0, "replay_ms": 0.0,
                 "bytes": 0}
        if not os.path.exists(self.path):
            return stats
        stats["bytes"] = os.path.getsize(self.path)
        sessions: dict[str, dict] = {}
        with open(self.path, "rb") as fp:
            for meta, body in RecordReader(fp):
                stats["records"] += 1
                try:
                    d = json.loads(body)
                except ValueError:
                    continue
                if meta == REC_EPOCH:
                    stats["epoch"] = max(stats["epoch"],
                                         int(d.get("e", 0)))
                elif meta == REC_OPEN and d["s"] not in sessions:
                    # never clobbers an existing record: a compaction
                    # snapshot supersedes any healed-late open record.
                    # "m" is the model column; a record without it
                    # decodes as the default model
                    sessions[d["s"]] = {
                        "prompt": [int(t) for t in d.get("p", [])],
                        "budget": int(d.get("b", 0)),
                        "emitted": [], "state": "running",
                        "error_code": None,
                        "model": str(d.get("m") or DEFAULT_MODEL)}
                elif meta == REC_SNAP:
                    sessions[d["s"]] = {
                        "prompt": [int(t) for t in d.get("p", [])],
                        "budget": int(d.get("b", 0)),
                        "emitted": [int(t) for t in d.get("e", [])],
                        "state": str(d.get("st", "running")),
                        "error_code": (None if d.get("ec") is None
                                       else int(d["ec"])),
                        "model": str(d.get("m") or DEFAULT_MODEL)}
                elif meta == REC_TOK:
                    rec = sessions.get(d["s"])
                    if rec is None:
                        stats["orphan_tok"] += 1
                        continue
                    cur = int(d.get("c", 0))
                    have = len(rec["emitted"])
                    if cur == have + 1:
                        rec["emitted"].append(int(d["t"]))
                    elif cur > have + 1:
                        # a lost record left a hole: everything past it
                        # is unplaceable — the resume re-decodes the
                        # tail instead (never serves a gapped record)
                        stats["gap_tok"] += 1
                    # cur <= have: duplicate from a healed tail; ignore
                elif meta == REC_FIN:
                    rec = sessions.get(d["s"])
                    if rec is not None:
                        code = (None if d.get("ec") is None
                                else int(d["ec"]))
                        rec["state"] = "failed" if code else "finished"
                        rec["error_code"] = code
        stats["sessions"] = len(sessions)
        stats["replay_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        self.recovered = sessions
        self.epoch = stats["epoch"]
        self.records = stats["records"]
        return stats

    # ---- appends (write-ahead, non-raising) ----

    def _write_locked(self, meta: bytes, body: bytes) -> None:
        self._writer.write(body, meta)
        self._writer.flush()
        if self.fsync:
            os.fsync(self._fp.fileno())
        self.records += 1

    def _append(self, meta: bytes, body: dict) -> bool:
        """Append one record, draining the pending (un-durable) tail
        first so record order is preserved across failures.  Returns
        True when THIS record reached the file."""
        raw = json.dumps(body, separators=(",", ":")).encode()
        with self._mu:
            if self._closed:
                return False
            self.appends += 1
            if (fault.ENABLED and
                    fault.hit(fault.ROUTER_WAL_APPEND,
                              path=self.path) is not None):
                self.append_failures += 1
                self._pending.append((meta, raw))
                return False
            try:
                while self._pending:
                    pm, pb = self._pending[0]
                    self._write_locked(pm, pb)
                    self._pending.popleft()
                    self.healed_records += 1
                self._write_locked(meta, raw)
            except OSError:
                self.append_failures += 1
                self._pending.append((meta, raw))
                return False
            if self.records >= self.compact_min_records:
                self._compact_cv.notify()
            return True

    def append_open(self, sid: str, prompt, budget: int,
                    model: Optional[str] = None) -> bool:
        body = {"s": sid, "p": [int(t) for t in prompt],
                "b": int(budget)}
        # the model column rides only when it says something: a
        # default-model record stays byte-identical to a catalog-less
        # one
        if model and model != DEFAULT_MODEL:
            body["m"] = str(model)
        return self._append(REC_OPEN, body)

    def append_tok(self, sid: str, tok: int, cursor: int) -> bool:
        return self._append(REC_TOK,
                            {"s": sid, "c": int(cursor), "t": int(tok)})

    def append_fin(self, sid: str, error_code=None) -> bool:
        ec = None if error_code is None else int(error_code)
        return self._append(REC_FIN, {"s": sid, "ec": ec})

    def bump_epoch(self) -> int:
        """Advance the fleet membership epoch and persist it — called
        by a router ADOPTING this WAL, so its floor pushes strictly
        supersede the dead predecessor's (epoch fencing)."""
        with self._mu:
            self.epoch += 1
            e = self.epoch
        self._append(REC_EPOCH, {"e": e})
        return e

    # ---- compaction ----

    def _compact_loop(self) -> None:
        while True:
            with self._mu:
                while not self._closed and not self._compact_due():
                    self._compact_cv.wait(0.5)
                if self._closed:
                    return
            try:
                self.compact()
            except Exception:
                import logging
                logging.getLogger(__name__).info(
                    "session WAL compaction failed", exc_info=True)
                time.sleep(0.5)

    def _compact_due(self) -> bool:
        if self.snapshot_source is None:
            return False
        if self.records < self.compact_min_records:
            return False
        try:
            return os.path.getsize(self.path) >= self.compact_bytes \
                or self.records >= self.compact_min_records
        except OSError:
            return False

    def compact(self) -> Optional[dict]:
        """Rewrite the log as one snapshot of the CURRENT table (epoch
        record + one ``snap`` per session) through an atomic rename.
        Returns the compaction stats row, or None without a
        ``snapshot_source``.

        The snapshot is taken UNDER the WAL lock: an append landing
        between snapshot and rename would otherwise be a durable token
        the rewrite silently drops — a write-ahead violation.  Lock
        order is therefore wal._mu -> table._mu -> session.mu, and no
        append path may hold a table/session lock when it reaches the
        WAL (the appenders in router.py release them first)."""
        src = self.snapshot_source
        if src is None:
            return None
        with self._mu:
            if self._closed:
                return None
            rows = src()
            before_records = self.records
            try:
                before_bytes = os.path.getsize(self.path)
            except OSError:
                before_bytes = 0
            tmp = self.path + ".compact"
            with open(tmp, "wb") as fp:
                w = RecordWriter(fp)
                w.write(json.dumps({"e": self.epoch},
                                   separators=(",", ":")).encode(),
                        REC_EPOCH)
                n = 1
                for r in rows:
                    row = {"s": r["sid"], "p": r["prompt"],
                           "b": r["budget"], "e": r["emitted"],
                           "st": r["state"], "ec": r["error_code"]}
                    m = r.get("model")
                    if m and m != DEFAULT_MODEL:
                        row["m"] = str(m)
                    w.write(json.dumps(
                        row, separators=(",", ":")).encode(), REC_SNAP)
                    n += 1
                w.flush()
                os.fsync(fp.fileno())
            self._fp.close()
            os.replace(tmp, self.path)
            self._fp = open(self.path, "ab")
            self._writer = RecordWriter(self._fp)
            # the snapshot supersedes any un-durable pending tail (its
            # tokens live in the table state just snapped); healing it
            # afterwards would replay stale open records over snaps
            self.healed_records += len(self._pending)
            self._pending.clear()
            self.records = n
            self.compactions += 1
            self.last_compaction = {
                "t": time.time(),
                "records_before": before_records, "records_after": n,
                "bytes_before": before_bytes,
                "bytes_after": os.path.getsize(self.path),
            }
            return dict(self.last_compaction)

    # ---- lifecycle / introspection ----

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def stats(self) -> dict:
        with self._mu:
            return {
                "path": self.path,
                "size_bytes": self.size_bytes(),
                "records": self.records,
                "epoch": self.epoch,
                "appends": self.appends,
                "append_failures": self.append_failures,
                "pending": len(self._pending),
                "healed_records": self.healed_records,
                "compactions": self.compactions,
                "last_compaction": (dict(self.last_compaction)
                                    if self.last_compaction else None),
                "replay": dict(self.replay),
            }

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._compact_cv.notify_all()
            t = self._compact_thread
        if t is not None:
            t.join(5.0)
        with self._mu:
            try:
                self._writer.flush()
            except Exception:
                pass
            try:
                self._fp.close()
            except Exception:
                pass
