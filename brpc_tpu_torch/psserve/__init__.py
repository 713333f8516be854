"""brpc_tpu_torch.psserve: the sharded embedding / parameter-server
service (the port of ``brpc_tpu/psserve``).

An embedding table row-sharded over partitions, served as
``PS.Lookup`` / ``PS.Update`` (sparse scatter-add, or the fused
optimizer apply) plus dense ``PS.Pull``/``PS.Push`` RPCs, with

  * client-side routing through the port's **PartitionChannel**: each
    request's key set split by shard ownership, fanned out
    sub-call-per-partition, reassembled in key order (client.py),
  * server-side coalescing through the port's **DynamicBatcher**
    (service.py: key-count buckets, eager cut-through),
  * idempotent updates (53-bit update_ids) and per-shard version
    counters giving read-your-writes and exactly-once apply,
  * the rows and optimizer slots on the card (shard.py).

:func:`psserve_snapshot` gathers the live components' stats.  The
co-located lowered table (``psserve/lowered.py``) is the mesh slice,
ROADMAP Queue 1 item 9: until then no table registers in the local
registry, and a client's ``ici="auto"`` means the wire.
"""
from __future__ import annotations

import weakref

from ..butil.lockprof import InstrumentedLock

_mu = InstrumentedLock("psserve.registry")
_shards: list = []      # weakrefs to (EmbeddingShardServer, PSService)
_clients: list = []     # weakrefs to PSClient


def _register_shard(shard, svc=None) -> None:
    with _mu:
        _shards.append((weakref.ref(shard),
                        weakref.ref(svc) if svc is not None else None))


def _register_client(client) -> None:
    with _mu:
        _clients.append(weakref.ref(client))


# ---- the local-table registry (a co-located lowered table) ----

_local_tables: dict[str, "weakref.ref"] = {}


def register_local_table(table, name: str = "ps") -> None:
    """Publish ``table`` as THE local lowered table for PS clients
    named after the same logical table (default ``"ps"``)."""
    with _mu:
        _local_tables[str(name)] = weakref.ref(table)


def unregister_local_table(name: str = "ps") -> None:
    with _mu:
        _local_tables.pop(str(name), None)


def find_local_table(name: str, vocab: int, dim: int):
    """The registered local table matching (name, vocab, dim), or None:
    geometry must match exactly."""
    with _mu:
        ref = _local_tables.get(str(name))
    t = ref() if ref is not None else None
    if t is None or t.vocab != int(vocab) or t.dim != int(dim):
        return None
    return t


def psserve_snapshot() -> dict:
    """Live PS components' stats: per-shard row counts, version
    counters and hot-key histograms, batcher coalescing stats, client
    routing counters, and the per-serializer wire counters."""
    shards = []
    clients = []
    with _mu:
        shard_refs = list(_shards)
        client_refs = list(_clients)
    for sref, vref in shard_refs:
        s = sref()
        if s is None:
            continue
        entry = s.stats()
        svc = vref() if vref is not None else None
        if svc is not None:
            entry["batchers"] = {
                b.name: b.stats() for b in
                (svc._lookup_b, svc._update_b, svc._update_tb)
                if b is not None}
        shards.append(entry)
    for cref in client_refs:
        c = cref()
        if c is not None:
            clients.append(c.stats())
    # prune dead refs opportunistically
    with _mu:
        _shards[:] = [e for e in _shards if e[0]() is not None]
        _clients[:] = [r for r in _clients if r() is not None]
    from .service import wire_counters
    return {"shards": shards, "clients": clients,
            "wire": wire_counters()}


from .shard import (  # noqa: E402,F401
    EmbeddingShardServer, init_embedding_table, owners_for, shard_bounds,
)
from .client import PSClient  # noqa: E402,F401
from .service import (  # noqa: E402,F401
    PSService, register_psserve, unregister_psserve,
)
