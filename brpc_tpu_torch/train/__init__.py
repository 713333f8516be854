"""brpc_tpu_torch.train: the training plane (the port of
``brpc_tpu/train``).

  * ``optimizer.py``: :class:`OptimizerSpec` and the fused
    scatter-and-slot-update math.  ``PS.Update`` with an optimizer spec
    runs the gradient scatter AND the momentum/Adam slot step as one
    in-place apply on the shard's device, with the slot rows living
    WITH the shard: momentum never crosses the wire;
  * ``trainer.py``: :class:`DataParallelTrainer`: N worker threads
    pulling minibatches, Lookup through PSClient, local grads by
    autograd, PS.Update waves under bounded-staleness gating, periodic
    Pull-based eval showing the loss decrease THROUGH the service;
  * ``arbiter.py``: :class:`TrafficArbiter` (the overload ladder's
    background rungs: pace and shed trainer waves BEFORE serving traffic
    is touched) and :class:`MixedWorkloadHarness` (one fleet carrying
    zipf lookups, streamed generations and update waves at once).

``trainer`` and ``arbiter`` import lazily (PEP 562), so the wire layers
can import :class:`OptimizerSpec` alone.
"""
from __future__ import annotations

from .optimizer import OptimizerSpec, oracle_apply

__all__ = ["OptimizerSpec", "oracle_apply", "DataParallelTrainer",
           "TrafficArbiter", "MixedWorkloadHarness"]

_LAZY = {
    "DataParallelTrainer": ".trainer",
    "TrafficArbiter": ".arbiter",
    "MixedWorkloadHarness": ".arbiter",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
