"""Serving-stage tags for host hot-path attribution (a copy of
``brpc_tpu/butil/stagetag.py``, as the tag source only: the port has
no sampling profiler yet).

Every thread on the serving path belongs to a STAGE -- batch
formation, prefill, decode step, emit fan-out, span submit -- and the
lock ledger (``butil/lockprof.py``) labels each lock's last holder with
it.  Two sources, explicit beats implicit:

  * explicit -- code that knows its stage marks a region with
    ``stage("prefill")`` (the engine thread runs admit, prefill and
    decode, so its name alone cannot split them);
  * implicit -- the thread-name prefix map below.

Lookups are dict reads under the interpreter lock: no lock on any hot
path.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

# thread ident -> explicitly marked stage (only the owning thread
# writes its entry)
_explicit: dict[int, str] = {}

# thread-name prefix -> stage (first match wins)
_NAME_STAGES = (
    ("serving-batcher", "batch_formation"),
    ("serving-engine", "decode_step"),
    ("serving-supervisor", "decode_step"),
    ("serving-emit", "emit_fanout"),
    ("kv-migrate", "migrate"),
    ("bvar-collector", "span_submit"),
    ("rpcz-spanq", "span_submit"),
    ("bvar-sampler", "bvar_sampler"),
    ("hotspot-sampler", "hotspot_sampler"),
    # the native core's executor threads have no Python Thread object;
    # threading registers them as Dummy-N at their first Python callback
    ("Dummy", "frame_pump"),
    ("svc-tag-", "rpc_handler"),
    ("usercode", "rpc_handler"),
    ("grpc-", "rpc_handler"),
    ("console-dashboard", "console"),
    ("MainThread", "main"),
)


def stage_of(tid: int, thread_name: str = "") -> str:
    """Stage of thread `tid` (an explicit mark wins over the name map)."""
    s = _explicit.get(tid)
    if s is not None:
        return s
    for prefix, stage_name in _NAME_STAGES:
        if thread_name.startswith(prefix):
            return stage_name
    return "other"


def current_stage() -> str:
    t = threading.current_thread()
    return stage_of(t.ident or 0, t.name)


@contextmanager
def stage(name: str):
    """Mark the calling thread as running `name` for the duration."""
    tid = threading.get_ident()
    prev = _explicit.get(tid)
    _explicit[tid] = name
    try:
        yield
    finally:
        if prev is None:
            _explicit.pop(tid, None)
        else:
            _explicit[tid] = prev
