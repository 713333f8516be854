"""Serving: the continuous-batching decode engine, its draft proposers
for speculative decoding, the dynamic batcher, the engine supervisor,
the ``Serving`` RPC service in front of them, and the cluster front
door (the router, its session WAL, the ``_cluster`` and ``_telemetry``
services, the model plane, the SLO engine).

Every live batcher, engine, supervisor and router registers here,
weakly and by name (as in ``brpc_tpu/serving/__init__.py``), so the
``/serving``, ``/cluster`` and ``/fleet`` console pages
(``serving_snapshot``, ``cluster_snapshot``, ``fleet_snapshot``) list
them without keeping a closed component alive; ``fleet_trace_spans``
is ``/rpcz?trace_id=``'s cross-process read.  Every retired decode
attempt (engine) and every finished supervised generation (supervisor)
appends a summary record -- trace id, TTFT, inter-token gaps, prefix
hit, restarts -- to a bounded ring here; ``generations_snapshot`` rolls
the ring up beside the serving-wide TTFT and inter-token recorders.
"""
from __future__ import annotations

import weakref
from collections import deque

from ..butil.lockprof import InstrumentedLock

_reg_mu = InstrumentedLock("serving.registry")
_batchers: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_engines: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_supervisors: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_routers: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def _register_batcher(b) -> None:
    with _reg_mu:
        _batchers[b.name] = b


def _register_engine(e) -> None:
    with _reg_mu:
        _engines[e.name] = e


def _register_supervisor(s) -> None:
    with _reg_mu:
        _supervisors[s.name] = s


def _register_router(r) -> None:
    with _reg_mu:
        _routers[r.name] = r


def cluster_snapshot() -> dict:
    """Live routers' stats: the ``/cluster`` console page's data (per
    router the replica table, session counts, resume stats, the
    gradient's per-level fire counters)."""
    with _reg_mu:
        routers = dict(_routers)
    return {
        "routers": {name: r.stats() for name, r in sorted(routers.items())},
    }


def fleet_snapshot(points: int = 32) -> dict:
    """Live routers' fleet telemetry: the ``/fleet`` console page's data
    (per router the collector's state -- pulls, bytes, tombstones --,
    the windowed series rings, the per-model scoreboard, the canary
    picks, and the SLO engine's state and decision trail)."""
    with _reg_mu:
        routers = dict(_routers)
    return {
        "routers": {name: r.fleet_snapshot(points)
                    for name, r in sorted(routers.items())},
    }


def fleet_trace_spans(trace_id: int) -> list:
    """The spans of one trace from other processes, fanned out through
    every live router's collector (what ``/rpcz?trace_id=`` stitches);
    empty when no router is registered or nothing was collected."""
    with _reg_mu:
        routers = dict(_routers)
    merged: dict = {}
    for r in routers.values():
        try:
            for s in r.trace_fanout(trace_id):
                merged.setdefault(
                    (s.trace_id, s.span_id, s.kind, s.start_us), s)
        except Exception:
            continue     # a dead peer must not hide the others' spans
    return list(merged.values())


def serving_snapshot() -> dict:
    """Live components' stats: the ``/serving`` console page's data."""
    with _reg_mu:
        batchers = dict(_batchers)
        engines = dict(_engines)
        supervisors = dict(_supervisors)
    return {
        "batchers": {name: b.stats() for name, b in sorted(batchers.items())},
        "engines": {name: e.stats() for name, e in sorted(engines.items())},
        "supervisors": {name: s.stats()
                        for name, s in sorted(supervisors.items())},
    }


# ---- the recent-generation ring ----

_GEN_KEEP = 256
_gen_mu = InstrumentedLock("serving.generations")
_recent_gens: deque = deque(maxlen=_GEN_KEEP)


def record_generation(rec: dict) -> None:
    """Append one finished generation or attempt summary."""
    with _gen_mu:
        _recent_gens.append(rec)


def recent_generations(limit: int = 50) -> list[dict]:
    with _gen_mu:
        gens = list(_recent_gens)
    return gens[-limit:]


def generations_snapshot(limit: int = 50) -> dict:
    """Aggregate TTFT and inter-token percentiles from the serving-wide
    recorders, the prefix-skip ratio and speculative acceptance over
    the recent ring, the supervisors' recoveries, and the recent
    records themselves (newest last)."""
    from .engine import latency_recorders
    rec = latency_recorders()
    recent = recent_generations(limit)
    # engine attempt records only (they carry prefix_hit): supervisor
    # rows describe the same generations again
    prompt = sum(r["prompt_len"] for r in recent if "prefix_hit" in r)
    hit = sum(r["prefix_hit"] for r in recent if "prefix_hit" in r)
    with _reg_mu:
        supervisors = dict(_supervisors)
    recoveries = sum(s.restarts_total.get_value()
                     for s in supervisors.values())
    spec_rows = [r for r in recent if "accept_rate" in r]
    proposed = sum(r.get("spec_proposed", 0) for r in spec_rows)
    accepted = sum(r.get("spec_accepted", 0) for r in spec_rows)

    def summary(r) -> dict:
        return {"count": r.count(), "avg": round(r.latency(), 1),
                "p50": round(r.latency_percentile(0.5), 1),
                "p99": round(r.latency_percentile(0.99), 1)}

    return {
        "aggregates": {
            "speculative": {
                "generations": len(spec_rows),
                "accept_rate": round(accepted / proposed, 4) if proposed
                else 0.0,
                "avg_tokens_per_step": round(
                    sum(r["tokens_per_step"] for r in spec_rows)
                    / len(spec_rows), 2) if spec_rows else 0.0,
            },
            "ttft_us": summary(rec["ttft"]),
            "itl_us": summary(rec["itl"]),
            "prefill_skip_ratio": round(hit / prompt, 4) if prompt else 0.0,
            "recoveries": recoveries,
        },
        "recent": recent,
    }


# the engine, batcher, service, proposers and supervisor import torch;
# they load at first use, so the router tier (host code) starts without
_LAZY = {
    "DynamicBatcher": ".batcher", "DecodeEngine": ".engine",
    "ScoreClient": ".service", "ServingService": ".service",
    "http_generate_handler": ".service", "register_serving": ".service",
    "DraftModelProposer": ".speculative", "DraftProposer": ".speculative",
    "NGramProposer": ".speculative", "as_proposer": ".speculative",
    "EngineSupervisor": ".supervisor",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)


from .ladder import OverloadLadder  # noqa: E402,F401
from .router import (ClusterRouter, ReplicaHandle,  # noqa: E402,F401
                     RouterClient, RouterService, SessionTable,
                     register_router)
from .session_wal import SessionWAL  # noqa: E402,F401
from .cluster_control import (CLUSTER_SERVICE,  # noqa: E402,F401
                              ClusterControlService,
                              register_cluster_control)
from .modelplane import (DEFAULT_MODEL, CanarySplit,  # noqa: E402,F401
                         ModelCatalog, ModelMetrics, ReplicaDeployments,
                         cluster_deploy, deployment_key,
                         model_fingerprint, split_deployment_key)
from .telemetry import (TELEMETRY_SERVICE,  # noqa: E402,F401
                        FleetCollector, TelemetryService,
                        register_telemetry, telemetry_snapshot)
from .slo import Objective, SLOEngine  # noqa: E402,F401
