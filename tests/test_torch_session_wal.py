"""The port's session WAL held against the JAX package's.

Counterparts of ``tests/test_session_wal.py`` over
``brpc_tpu_torch.serving.session_wal`` (roundtrip, torn tail, lost
middle record, pending-tail healing, epoch persistence, compaction,
auto-compaction, table adoption, write-ahead against the sink), and the
two packages on one file: a WAL written by either recovers in the other
with equal session snapshots.
"""
import os

import pytest

from brpc_tpu_torch import fault
from brpc_tpu_torch.serving import SessionTable, SessionWAL

from testutil import wait_until

SITE = fault.ROUTER_WAL_APPEND


@pytest.fixture(autouse=True)
def _hygiene():
    fault.clear()
    yield
    fault.clear()


def _wal(tmp_path, **kw):
    kw.setdefault("auto_compact", False)
    return SessionWAL(str(tmp_path / "s.wal"), **kw)


def test_roundtrip_replay(tmp_path):
    w = _wal(tmp_path)
    w.append_open("a", [1, 2, 3], 8)
    for i, t in enumerate((10, 11, 12), 1):
        w.append_tok("a", t, i)
    w.append_fin("a", None)
    w.append_open("b", [4, 5], 4)
    w.append_tok("b", 20, 1)
    w.append_open("c", [6], 4)
    w.append_fin("c", 2004)          # a failed session keeps its code
    w.close()

    w2 = _wal(tmp_path)
    assert w2.recovered["a"] == {
        "prompt": [1, 2, 3], "budget": 8, "emitted": [10, 11, 12],
        "state": "finished", "error_code": None, "model": "default"}
    assert w2.recovered["b"]["state"] == "running"
    assert w2.recovered["b"]["emitted"] == [20]
    assert w2.recovered["c"]["state"] == "failed"
    assert w2.recovered["c"]["error_code"] == 2004
    assert w2.replay["sessions"] == 3
    assert w2.replay["orphan_tok"] == 0 and w2.replay["gap_tok"] == 0
    w2.close()


def test_torn_tail_loses_only_itself(tmp_path):
    w = _wal(tmp_path)
    w.append_open("a", [1], 8)
    w.append_tok("a", 10, 1)
    w.append_tok("a", 11, 2)
    w.close()
    p = str(tmp_path / "s.wal")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 3)   # tear the last record
    w2 = _wal(tmp_path)
    assert w2.recovered["a"]["emitted"] == [10]
    w2.close()


def test_lost_middle_record_gaps_the_tail(tmp_path):
    """A corrupt record in the middle (resync skips it) must not let
    later cursors re-seat: they count as gap tokens and the recovered
    cursor stays before the hole."""
    w = _wal(tmp_path)
    w.append_open("a", [1], 8)
    w.append_tok("a", 10, 1)
    end_before = os.path.getsize(str(tmp_path / "s.wal"))
    w.append_tok("a", 11, 2)
    end_mid = os.path.getsize(str(tmp_path / "s.wal"))
    w.append_tok("a", 12, 3)
    w.close()
    with open(str(tmp_path / "s.wal"), "r+b") as f:
        f.seek(end_before)
        f.write(b"\xff" * (end_mid - end_before))   # smash record 2
    w2 = _wal(tmp_path)
    assert w2.recovered["a"]["emitted"] == [10]
    assert w2.replay["gap_tok"] >= 1
    w2.close()


def test_pending_tail_heals_in_order(tmp_path):
    w = _wal(tmp_path)
    w.append_open("x", [9], 8)
    plan = fault.FaultPlan(7).on(SITE, fault.ERROR, times=2)
    with fault.injected(plan):
        assert w.append_tok("x", 1, 1) is False
        assert w.append_tok("x", 2, 2) is False
    st = w.stats()
    assert st["pending"] == 2 and st["append_failures"] == 2
    assert w.append_tok("x", 3, 3) is True    # drains the tail first
    assert w.stats()["pending"] == 0
    assert w.stats()["healed_records"] == 2
    w.close()
    w2 = _wal(tmp_path)
    assert w2.recovered["x"]["emitted"] == [1, 2, 3]
    w2.close()


def test_unhealed_tail_is_lost_but_prefix_survives(tmp_path):
    w = _wal(tmp_path)
    w.append_open("x", [9], 8)
    w.append_tok("x", 1, 1)
    plan = fault.FaultPlan(7).on(SITE, fault.ERROR, times=8)
    with fault.injected(plan):
        w.append_tok("x", 2, 2)
        w.append_tok("x", 3, 3)
        w.close()                      # dies without healing
    w2 = _wal(tmp_path)
    assert w2.recovered["x"]["emitted"] == [1]
    w2.close()


def test_epoch_persists_and_fences_forward(tmp_path):
    w = _wal(tmp_path)
    assert w.epoch == 0
    assert w.bump_epoch() == 1
    assert w.bump_epoch() == 2
    w.close()
    w2 = _wal(tmp_path)
    assert w2.epoch == 2
    assert w2.bump_epoch() == 3
    w2.close()


def test_compaction_rewrites_and_bounds_growth(tmp_path):
    rows = [{"sid": "a", "prompt": [1], "budget": 64,
             "emitted": list(range(50)), "state": "running",
             "error_code": None}]
    w = _wal(tmp_path)
    w.snapshot_source = lambda: rows
    w.append_open("a", [1], 64)
    for i in range(50):
        w.append_tok("a", i, i + 1)
    w.bump_epoch()
    before = w.size_bytes()
    row = w.compact()
    assert row["records_after"] == 2          # epoch + one snap
    assert w.size_bytes() < before
    assert w.stats()["compactions"] == 1
    assert w.stats()["last_compaction"]["records_before"] == 52
    w.append_tok("a", 50, 51)
    w.close()
    w2 = _wal(tmp_path)
    assert w2.recovered["a"]["emitted"] == list(range(51))
    assert w2.epoch == 1
    w2.close()


def test_auto_compaction_triggers_on_thresholds(tmp_path):
    rows = [{"sid": "a", "prompt": [1], "budget": 1 << 20,
             "emitted": [0], "state": "running", "error_code": None}]
    w = SessionWAL(str(tmp_path / "s.wal"), compact_min_records=32,
                   compact_bytes=1 << 30)
    w.snapshot_source = lambda: rows
    for i in range(64):
        w.append_tok("a", i, i + 1)
    # the compactor may fire mid-loop and again after it: wait for the
    # stable outcome
    assert wait_until(lambda: w.stats()["compactions"] >= 1
                      and w.stats()["records"] < 32, timeout=30.0)
    w.close()


def test_table_recover_adopts_sessions(tmp_path):
    p = str(tmp_path / "t.wal")
    t = SessionTable(wal=p)
    s1 = t.new_session([1, 2, 3], 8)
    s2 = t.new_session([4, 5, 6], 8)
    for tok in (100, 101, 102):
        s1.append(tok)
    s2.append(200)
    s1.finish(None)
    t.close()

    t2 = SessionTable.recover(p)
    r1, r2 = t2.get(s1.sid), t2.get(s2.sid)
    assert r1.state == "finished" and r1.emitted == [100, 101, 102]
    assert r2.state == "suspended" and r2.cursor == 1
    assert t2.replay_stats["live"] == 1
    assert t2.replay_stats["finished"] == 1
    assert t2.wal.stats()["compactions"] == 1   # adoption compacts
    r2.append(201)
    t2.close()
    t3 = SessionTable.recover(p)
    assert t3.get(s2.sid).emitted == [200, 201]
    t3.close()


def test_write_ahead_vs_sink(tmp_path):
    """The WAL record lands before the delivery callback runs."""
    p = str(tmp_path / "t.wal")
    t = SessionTable(wal=p)
    s = t.new_session([1], 4)
    seen = []

    def sink(tok):
        w2 = SessionWAL(p, auto_compact=False)
        try:
            seen.append(list(w2.recovered[s.sid]["emitted"]))
        finally:
            w2.close()

    s.attach(0, sink, lambda err: None)
    s.append(7)
    s.append(8)
    assert seen == [[7], [7, 8]]
    t.close()


# ---------------------------------------------------------------------------
# one file, two packages
# ---------------------------------------------------------------------------

def _write_history(table_cls, path):
    """The same history through either package's SessionTable: a
    finished, a failed, a live and a suspended-by-gap session, a
    non-default model, and an epoch bump.  Returns the session ids."""
    t = table_cls(wal=path)
    a = t.new_session([1, 2, 3], 8)
    b = t.new_session([4, 5], 6, model="m@v2")
    c = t.new_session([6], 4)
    for tok in (10, 11, 12):
        a.append(tok)
    a.finish(None)
    b.append(20)
    b.append(21)
    c.append(30)
    t.wal.append_fin(c.sid, 2004)
    t.wal.bump_epoch()
    t.close()
    return a.sid, b.sid, c.sid


def _snapshots(table):
    rows = table.snapshot(limit=100)
    return sorted((r["session_id"], r["state"], r["model"], r["cursor"],
                   r["budget"], r["prompt_len"], r["error_code"])
                  for r in rows)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_written_by_one_package_recovers_in_the_other(tmp_path, writer):
    from brpc_tpu.serving import SessionTable as JSessionTable
    tables = {"port": SessionTable, "jax": JSessionTable}
    reader = "jax" if writer == "port" else "port"
    src = str(tmp_path / "w.wal")
    sids = _write_history(tables[writer], src)
    # each package recovers its own copy of the same bytes
    with open(src, "rb") as f:
        raw = f.read()
    paths = {}
    for k in ("port", "jax"):
        paths[k] = str(tmp_path / f"{k}.wal")
        with open(paths[k], "wb") as f:
            f.write(raw)
    own = tables[writer].recover(paths[writer])
    other = tables[reader].recover(paths[reader])
    try:
        assert _snapshots(own) == _snapshots(other)
        assert own.replay_stats == {**other.replay_stats,
                                    "replay_ms": own.replay_stats[
                                        "replay_ms"]}
        for sid in sids:
            assert own.get(sid).emitted == other.get(sid).emitted
            assert own.get(sid).prompt == other.get(sid).prompt
        assert own.wal.epoch == other.wal.epoch == 1
        assert other.get(sids[1]).model == "m@v2"
        assert other.get(sids[2]).state == "failed"
    finally:
        own.close()
        other.close()
    # the compacted files (adoption compacts) are byte-equal too
    with open(paths["port"], "rb") as f1, open(paths["jax"], "rb") as f2:
        assert f1.read() == f2.read()
