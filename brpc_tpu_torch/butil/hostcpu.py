"""Per-stage host-CPU accounting (a copy of ``brpc_tpu/butil/hostcpu.py``).

``time.thread_time()`` deltas recorded by the serving path -- batch
formation (the batcher), prefill and decode-step bookkeeping (the
engine thread, MINUS the runner calls, which go to ``model_compute``),
emit fan-out (the per-request emitter threads), span submit (the span
drainers) -- accumulate into one Adder per stage and roll up into

    serving_host_us_per_token = host-CPU microseconds of every host
        stage / tokens emitted

``model_compute`` (the runner's prefill/step/verify calls, kernel
launches included) stays out of the rollup: the metric sizes the host
bookkeeping around the card's work, not the work itself.  The native
frame pump runs no Python and is not counted here.
"""
from __future__ import annotations

from ..bvar.reducer import Adder, PassiveStatus

# stages that are host bookkeeping (counted in the per-token rollup)
HOST_STAGES = ("batch_formation", "prefill", "decode_step",
               "emit_fanout", "span_submit")
# informational: CPU spent inside the runner calls
MODEL_STAGE = "model_compute"

_adders: dict[str, Adder] = {
    s: Adder(f"serving_host_cpu_{s}_us")
    for s in HOST_STAGES + (MODEL_STAGE,)
}

# tokens emitted by every engine (the rollup's denominator)
tokens_total = Adder("serving_tokens_total")


def add(stage: str, us: float) -> None:
    """Record `us` microseconds of host CPU against `stage`."""
    if us > 0:
        _adders[stage].add(int(us))


def host_us_per_token() -> float:
    toks = tokens_total.get_value()
    if not toks:
        return 0.0
    host = sum(_adders[s].get_value() for s in HOST_STAGES)
    return round(host / toks, 2)


def snapshot() -> dict:
    return {
        "per_stage_us": {s: _adders[s].get_value()
                         for s in HOST_STAGES + (MODEL_STAGE,)},
        "tokens": tokens_total.get_value(),
        "host_us_per_token": host_us_per_token(),
    }


PassiveStatus(host_us_per_token).expose("serving_host_us_per_token")
