"""ClusterRecoverPolicy -- the availability floor of circuit breaking (a
copy of ``brpc_tpu/policy/cluster_recover_policy.py``).

When most of a cluster is already isolated, isolating one more server
trades a little precision for a lot of availability.  The policy vetoes
an isolation that would leave fewer than ``min_working`` healthy
servers (or fewer than ``min_working_ratio`` of the cluster), and
reports ``in_recovery()`` while it does.
"""
from __future__ import annotations

import math
import threading

from ..bvar import Adder

_vetoed = Adder("rpc_cluster_recover_vetoed_isolations")


class ClusterRecoverPolicy:
    def __init__(self, min_working: int = 1,
                 min_working_ratio: float = 0.0):
        self.min_working = min_working
        self.min_working_ratio = min_working_ratio
        self._mu = threading.Lock()
        self._recovering = False

    def _floor(self, total: int) -> int:
        return max(self.min_working,
                   math.ceil(total * self.min_working_ratio))

    def can_isolate(self, total: int, healthy: int) -> bool:
        """True iff isolating one more server keeps the cluster at or
        above the availability floor."""
        ok = healthy - 1 >= self._floor(total)
        with self._mu:
            self._recovering = not ok
        if not ok:
            _vetoed.add(1)
        return ok

    def in_recovery(self) -> bool:
        with self._mu:
            return self._recovering


class _ChannelClusterGuard:
    """Binds a channel's live server view to the policy, so the circuit
    breaker can ask "may I isolate this endpoint?" without knowing about
    clusters."""

    def __init__(self, policy: ClusterRecoverPolicy, lb):
        self._policy = policy
        self._lb = lb

    def can_isolate(self, ep) -> bool:
        from .health_check import is_broken
        if is_broken(ep):
            # already isolated: isolating again removes nothing from the
            # pool, and a veto would stall the endpoint's hold ladder
            return True
        nodes = self._lb.servers()
        total = len(nodes)
        if total == 0:
            return True
        healthy = sum(1 for n in nodes if not is_broken(n.endpoint))
        return self._policy.can_isolate(total, healthy)
