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
    Pull-based eval showing the loss decrease THROUGH the service.

The reference's ``arbiter.py`` (``TrafficArbiter``,
``MixedWorkloadHarness``) imports the fleet telemetry plane and is
ROADMAP Queue 1 item 7, second half.  ``trainer`` imports lazily (PEP 562) so the
wire layers can import :class:`OptimizerSpec` alone.
"""
from __future__ import annotations

from .optimizer import OptimizerSpec, oracle_apply

__all__ = ["OptimizerSpec", "oracle_apply", "DataParallelTrainer"]

_NOT_PORTED = ("TrafficArbiter", "MixedWorkloadHarness")


def __getattr__(name: str):
    if name == "DataParallelTrainer":
        from .trainer import DataParallelTrainer
        return DataParallelTrainer
    if name in _NOT_PORTED:
        raise AttributeError(f"{name} (train/arbiter.py) is not ported "
                             f"yet: ROADMAP Queue 1 item 7, second half")
    raise AttributeError(name)
