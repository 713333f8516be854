"""Serving: the continuous-batching decode engine, its draft proposers
for speculative decoding, the dynamic batcher, the engine supervisor,
and the ``Serving`` RPC service in front of them.

Every live batcher, engine and supervisor registers here, weakly and by
name (as in ``brpc_tpu/serving/__init__.py``), so a console can list
them without keeping a closed component alive.  Every retired decode
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


def _register_batcher(b) -> None:
    with _reg_mu:
        _batchers[b.name] = b


def _register_engine(e) -> None:
    with _reg_mu:
        _engines[e.name] = e


def _register_supervisor(s) -> None:
    with _reg_mu:
        _supervisors[s.name] = s


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


from .batcher import DynamicBatcher  # noqa: E402,F401
from .engine import DecodeEngine  # noqa: E402,F401
from .service import (ScoreClient, ServingService,  # noqa: E402,F401
                      register_serving)
from .speculative import (DraftModelProposer, DraftProposer,  # noqa: E402,F401
                          NGramProposer, as_proposer)
from .supervisor import EngineSupervisor  # noqa: E402,F401
