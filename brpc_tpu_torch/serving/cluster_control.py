"""The ``_cluster`` control service: the wire half of the router's
overload gradient, fenced by epoch, and the model-deployment lifecycle
(a copy of ``brpc_tpu/serving/cluster_control.py``).

Each router tick pushes

    SetFloor {epoch, level, router}   (tensorframe)

to every remote replica.  The replica applies the level through the SAME
policy as an in-process handle
(:func:`~brpc_tpu_torch.serving.ladder.apply_level_to_components`), and
the reply carries its pressure report back: one RPC a tick browns the
fleet out together and feeds the router's gradient the remote pressures.

EPOCH FENCING.  ``epoch`` is the fleet membership epoch, persisted in the
session WAL and bumped by every adopting router.  The service latches
the highest epoch it has seen and REFUSES (EREQUEST, "stale epoch") a
push carrying a lower one: a superseded router that still ticks cannot
drag the fleet's overload posture around.  A dropped push needs nothing
special: the router re-pushes every tick (``fault.CLUSTER_FLOOR_PUSH``
drops one).

MODEL PLANE.  Every ``SetFloor``/``Report`` reply embeds the replica's
:class:`~brpc_tpu_torch.serving.modelplane.ReplicaDeployments` snapshot
as one JSON str field (``deployments``), so the router's catalog follows
a replica-side change within a tick.  ``Deploy``/``Undeploy``/``Drain``
pushes are fenced by the same epoch latch as ``SetFloor``.  Deploy here
is catalog-level: it marks an already-bound deployment's state or weight
or registers a catalog-only row; binding an engine happens at replica
spin-up (``fault.CLUSTER_DEPLOY`` refuses one).
"""
from __future__ import annotations

import time
from typing import Optional

from .. import errors, fault
from ..butil.lockprof import InstrumentedLock
from ..rpc.service import Service, method
from ..serving.ladder import apply_level_to_components
from ..serving.modelplane import (LOADING, WARM, publish_deployments)

CLUSTER_SERVICE = "_cluster"


class ClusterControlService(Service):
    """Replica-side half of the wire-level overload gradient (see
    module docstring).  Holds the same component references a local
    :class:`~brpc_tpu_torch.serving.router.ReplicaHandle` would, and applies
    pushed levels through the shared policy."""

    NAME = CLUSTER_SERVICE

    def __init__(self, *, supervisor=None, batcher=None, engine=None,
                 store=None, clamp_new_tokens: int = 32,
                 evict_pages: Optional[int] = None, name: str = "",
                 deployments=None):
        from ..serving.router import ReplicaHandle
        self.name = name
        self.clamp_new_tokens = int(clamp_new_tokens)
        self.evict_pages = evict_pages
        # a loopback handle purely for its pressures() logic
        self._handle = ReplicaHandle(
            "0.0.0.0:0", name=name or "local", supervisor=supervisor,
            batcher=batcher, engine=engine, store=store)
        self.deployments = deployments
        self._mu = InstrumentedLock("cluster.control")
        self.epoch = 0
        self.level = 0
        self.router = ""
        self.applied = 0
        self.refusals = 0
        self.deploy_ops = 0
        self.deploy_refusals = 0
        self.last_push_t: Optional[float] = None

    def _publish_into(self, resp: dict) -> dict:
        """Ride the deployment catalog on a control reply (one inline
        str field — tensorframe caps these at 1MB, plenty for any
        realistic deployment count)."""
        if self.deployments is not None:
            field = publish_deployments(self.deployments)
            if field is not None:
                resp["deployments"] = field
        return resp

    def _fence(self, cntl, req, *, counter: str) -> Optional[int]:
        """Latch-or-refuse the push's epoch.  Returns the epoch when
        admitted, None after set_failed (stale)."""
        epoch = int((req or {}).get("epoch", 0))
        with self._mu:
            if epoch < self.epoch:
                setattr(self, counter, getattr(self, counter) + 1)
                cntl.set_failed(
                    errors.EREQUEST,
                    f"stale epoch {epoch} < {self.epoch}: push from a "
                    f"superseded router refused")
                return None
            self.epoch = epoch
        return epoch

    @method(request="tensorframe", response="tensorframe")
    def SetFloor(self, cntl, req):
        req = req or {}
        epoch = self._fence(cntl, req, counter="refusals")
        if epoch is None:
            return None
        level = int(req.get("level", 0))
        with self._mu:
            self.level = level
            self.router = str(req.get("router", ""))
            self.applied += 1
            self.last_push_t = time.monotonic()
        h = self._handle
        apply_level_to_components(
            level, supervisor=h.supervisor, batcher=h.batcher,
            engine=h.engine, store=h.store,
            clamp_new_tokens=self.clamp_new_tokens,
            evict_pages=self.evict_pages)
        resp = {"applied": True, "epoch": epoch, "level": level}
        for k, v in h.pressures().items():
            resp[k] = float(v)
        return self._publish_into(resp)

    @method(request="tensorframe", response="tensorframe")
    def Report(self, cntl, req):
        """Pressure report without a level change — for pollers that
        are not the fleet's router (no epoch check: reading is free)."""
        resp = {"epoch": self.epoch, "level": self.level}
        for k, v in self._handle.pressures().items():
            resp[k] = float(v)
        return self._publish_into(resp)

    # -- model lifecycle -------------------------------------------------

    def _lifecycle(self, cntl, req, op: str):
        req = req or {}
        if self.deployments is None:
            cntl.set_failed(errors.EREQUEST,
                            "replica has no deployment table")
            return None
        model = str(req.get("model") or "")
        if not model:
            cntl.set_failed(errors.EREQUEST, 'missing "model"')
            return None
        if fault.ENABLED and fault.hit(fault.CLUSTER_DEPLOY, op=op,
                                       model=model, name=self.name):
            cntl.set_failed(errors.EINTERNAL,
                            f"injected deploy fault ({op} {model})")
            return None
        epoch = self._fence(cntl, req, counter="deploy_refusals")
        if epoch is None:
            return None
        deps = self.deployments
        if op == "deploy":
            state = str(req.get("state") or "") or None
            weight = int(req.get("weight", 1))
            row = deps.get(model)
            if row is not None:
                # re-deploy of a bound model: refresh weight/state
                # (canary re-weighting, un-drain) on the live bindings
                deps.deploy(model, engine=row.get("engine"),
                            batcher=row.get("batcher"),
                            store=row.get("store"),
                            prefix_fetcher=row.get("prefix_fetcher"),
                            state=state or row.get("state", LOADING),
                            weight=weight)
            else:
                # catalog-only deployment: visible on the plane, no
                # bindings yet (spin-up binds the engine later)
                deps.deploy(model, state=state or LOADING, weight=weight)
            if state == WARM:
                deps.mark_warm(model)
        elif op == "drain":
            if not deps.drain(model):
                cntl.set_failed(errors.EREQUEST,
                                f"model {model!r} not deployed here")
                return None
        elif op == "undeploy":
            if not deps.undeploy(model):
                cntl.set_failed(errors.EREQUEST,
                                f"model {model!r} not deployed here")
                return None
        with self._mu:
            self.deploy_ops += 1
        return self._publish_into(
            {"applied": True, "epoch": epoch, "op": op, "model": model})

    @method(request="tensorframe", response="tensorframe")
    def Deploy(self, cntl, req):
        """Register/refresh a deployment on this replica (epoch-fenced;
        ``state`` may force ``warm``, ``weight`` re-weights a canary)."""
        return self._lifecycle(cntl, req, "deploy")

    @method(request="tensorframe", response="tensorframe")
    def Undeploy(self, cntl, req):
        """Remove a deployment (epoch-fenced).  In-flight sessions on
        it keep their bindings; new placements stop immediately."""
        return self._lifecycle(cntl, req, "undeploy")

    @method(request="tensorframe", response="tensorframe")
    def Drain(self, cntl, req):
        """Mark a deployment draining (epoch-fenced): finishes
        in-flight work, leaves the placement ring for new sessions."""
        return self._lifecycle(cntl, req, "drain")

    def stats(self) -> dict:
        with self._mu:
            out = {
                "epoch": self.epoch,
                "level": self.level,
                "router": self.router,
                "applied": self.applied,
                "refusals": self.refusals,
                "deploy_ops": self.deploy_ops,
                "deploy_refusals": self.deploy_refusals,
                "push_age_s": (round(time.monotonic() - self.last_push_t,
                                     3) if self.last_push_t else None),
            }
        if self.deployments is not None:
            out["deployments"] = self.deployments.snapshot()
        return out


def register_cluster_control(server, *, supervisor=None, batcher=None,
                             engine=None, store=None,
                             clamp_new_tokens: int = 32,
                             evict_pages: Optional[int] = None,
                             name: str = "",
                             deployments=None) -> ClusterControlService:
    """Expose this replica to the wire-level overload gradient (call
    before ``server.start()``)."""
    svc = ClusterControlService(
        supervisor=supervisor, batcher=batcher, engine=engine,
        store=store, clamp_new_tokens=clamp_new_tokens,
        evict_pages=evict_pages, name=name, deployments=deployments)
    server.add_service(svc)
    return svc
