"""brpc_tpu_torch.migrate: the cross-replica KV data plane.

Port of ``brpc_tpu/migrate``.  Three capabilities on one page-shipping
core:

  * :class:`PageMigrator` / :class:`MigrateService` (plane.py): a
    committed radix prefix's pages (plus token runs, fingerprints and
    refcounts at the source) ship to a peer and splice into its
    :class:`~brpc_tpu_torch.kvcache.KVCacheStore` as committed radix
    nodes; ``PrefixAffinityLB.migrate_on_rebalance`` pushes warm
    prefixes to their new ring owner; a cold replica pulls a prefix
    (``make_prefix_fetcher``);
  * disaggregated prefill/decode (disagg.py): a :class:`PrefillReplica`
    runs the prompt's prefill and ships its pages to a decode process,
    whose engine prefix-hits them, paired by a
    :class:`DisaggCoordinator`;
  * cross-process failover (disagg.py): :class:`StandbySync`
    write-ahead-streams emitted tokens and live pages to a
    :class:`StandbyReplica`, which completes a dead primary's
    generation exactly once.

The port has no transfer fabric (``ici/dcn.py``): every page moves
host-serialized on the envelope.  Every live migrator, service and
standby registers here, weakly, for :func:`migration_snapshot`.
"""
from __future__ import annotations

import weakref

from ..butil.lockprof import InstrumentedLock

_reg_mu = InstrumentedLock("migrate.registry")
_migrators: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_services: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()
_standby: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def _register_migrator(m) -> None:
    with _reg_mu:
        _migrators[m.name] = m


def _register_service(s) -> None:
    with _reg_mu:
        _services[id(s)] = s


def _register_standby(s) -> None:
    with _reg_mu:
        _standby[s.name] = s


def migration_snapshot() -> dict:
    """Live migration state: global counters, per-migrator outbound
    route matrices, per-service inbound matrices, standby state and the
    live offer-table size (idles at 0)."""
    from ..ici import dcn
    from . import plane
    with _reg_mu:
        migrators = dict(_migrators)
        services = dict(_services)
        standby = dict(_standby)
    return {
        "counters": {
            "pages": plane.migrate_pages.get_value(),
            "bytes": plane.migrate_bytes.get_value(),
            "migrations_ok": plane.migrations_ok.get_value(),
            "migrations_failed": plane.migrations_failed.get_value(),
            "rollbacks": plane.migrate_rollbacks.get_value(),
            "zero_copy": plane.migrate_zero_copy.get_value(),
            "fallback": plane.migrate_fallback.get_value(),
            "splice_p99_us": round(
                plane.splice_recorder().latency_percentile(0.99), 1),
            "live_offers": dcn.live_offer_count(),
        },
        "outbound": {name: m.stats()
                     for name, m in sorted(migrators.items())},
        "inbound": [s.stats() for _, s in sorted(services.items())],
        "standby": {name: s.stats()
                    for name, s in sorted(standby.items())},
    }


from .plane import (  # noqa: E402,F401
    MIGRATE_SERVICE, MigrateService, PageMigrator, chunk_fingerprints,
    make_prefix_fetcher, rebalance_pusher, register_migration,
)
from .disagg import (  # noqa: E402,F401
    DisaggCoordinator, PrefillReplica, StandbyReplica, StandbySync,
    assume_stream, register_disagg_decode, register_disagg_prefill,
    register_standby,
)
