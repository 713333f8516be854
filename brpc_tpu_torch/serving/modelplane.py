"""The model plane: the catalog of named model deployments behind one
router front door (a copy of ``brpc_tpu/serving/modelplane.py``).

  * a DEPLOYMENT is a named ``model_id[@version]`` a replica serves:
    its engine/batcher/store bindings plus a lifecycle state --
    ``loading`` (bound, not yet proven by a generation), ``warm``
    (served at least one generation, or explicitly marked) and
    ``draining`` (finishes in-flight sessions but leaves the ring for
    NEW placements).  :class:`ReplicaDeployments` is the replica-side
    container; ``_cluster`` pressure replies publish its snapshot, so
    the router learns the fleet's catalog without an extra RPC.
  * the router-side :class:`ModelCatalog` folds those publications
    (and in-process handles) into "which replicas serve which model,
    in which state": the admission and failover constraint set.
  * ROUTING is keyed by ``(model, prefix)``: :func:`model_fingerprint`
    folds the deployment key into the prefix fingerprint, so two models
    sharing a token-identical prompt land on DIFFERENT ring points and
    never prefix-hit each other's pages.  The default (sole, anonymous)
    model keeps the plain prefix fingerprint, so a single-model fleet
    routes exactly as a catalog-less one.
  * a CANARY split across versions of one ``model_id``:
    :class:`CanarySplit` is a smooth weighted round-robin over version
    weights (deterministic), and :class:`ModelMetrics` keeps
    per-(model, version) TTFT/ITL/shed counters for ``/cluster``.

Fault sites: ``router.model_route`` (``fault.ROUTER_MODEL_ROUTE``: the
router's model-constrained pick is treated as a stale-catalog mis-route,
counted and re-routed) and ``cluster.deploy`` (``fault.CLUSTER_DEPLOY``:
a deploy/undeploy/drain push is refused on the wire).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional, Sequence

from ..butil.lockprof import InstrumentedLock

# the sole anonymous deployment a catalog-less fleet serves; WAL records
# without a model column decode as this
DEFAULT_MODEL = "default"

# deployment lifecycle states
LOADING = "loading"
WARM = "warm"
DRAINING = "draining"


def deployment_key(model_id: str, version: str = "") -> str:
    """The catalog key for one deployment: ``model_id`` alone, or
    ``model_id@version`` when versioned (the canary unit)."""
    model_id = str(model_id)
    return f"{model_id}@{version}" if version else model_id


def split_deployment_key(key: str) -> tuple[str, str]:
    """Inverse of :func:`deployment_key`: ``(model_id, version)`` with
    version ``""`` for unversioned keys."""
    key = str(key)
    if "@" in key:
        mid, _, ver = key.partition("@")
        return mid, ver
    return key, ""


def model_fingerprint(model: Optional[str], tokens: Sequence[int],
                      chunk_tokens: int = 16) -> int:
    """The ``(model, prefix)`` routing key: the prefix fingerprint with
    the deployment key folded in, so token-identical prompts against
    different models take DIFFERENT ring walks (and different ownership
    directory entries — zero cross-model page splices by construction).
    The default model keeps the plain prefix fingerprint: a
    single-model fleet's placement is that of catalog-less routing."""
    from ..policy.load_balancer import (_hash_murmur_like,
                                               prefix_fingerprint)
    fp = prefix_fingerprint(tokens, chunk_tokens)
    if not model or model == DEFAULT_MODEL:
        return fp
    return _hash_murmur_like(
        str(model).encode() + b"\x00" +
        (fp & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))


class ReplicaDeployments:
    """Replica-side deployment container: the ``model key ->
    (bindings, lifecycle state)`` map one serving process holds.
    Published (as :meth:`snapshot`) on every ``_cluster`` pressure
    reply; a serving service resolves a forwarded ``model`` field to
    the right engine through :meth:`resolve`."""

    def __init__(self, name: str = ""):
        self.name = str(name)
        self._mu = InstrumentedLock("modelplane.replica")
        self._deps: dict[str, dict] = {}

    def deploy(self, model: str, *, engine=None, batcher=None,
               store=None, prefix_fetcher=None, state: str = LOADING,
               weight: int = 1) -> dict:
        """Bind (or re-bind) one deployment.  ``state`` starts
        ``loading`` unless the caller knows better; the first completed
        generation flips it warm (:meth:`note_generation`)."""
        if state not in (LOADING, WARM, DRAINING):
            raise ValueError(f"bad deployment state {state!r}")
        model = str(model)
        mid, ver = split_deployment_key(model)
        with self._mu:
            row = self._deps.get(model)
            if row is None:
                row = {"model": model, "model_id": mid, "version": ver,
                       "state": state, "weight": max(1, int(weight)),
                       "generations": 0,
                       "engine": engine, "batcher": batcher,
                       "store": store,
                       "prefix_fetcher": prefix_fetcher}
                self._deps[model] = row
            else:
                # re-deploy refreshes bindings/weight and RESETS a
                # draining deployment to the requested state
                row["state"] = state
                row["weight"] = max(1, int(weight))
                for k, v in (("engine", engine), ("batcher", batcher),
                             ("store", store),
                             ("prefix_fetcher", prefix_fetcher)):
                    if v is not None:
                        row[k] = v
            return dict(row)

    def mark_warm(self, model: str) -> bool:
        with self._mu:
            row = self._deps.get(str(model))
            if row is None or row["state"] == DRAINING:
                return False
            row["state"] = WARM
            return True

    def note_generation(self, model: str) -> None:
        """One generation completed against this deployment — the
        warm-up proof: a ``loading`` deployment flips ``warm``."""
        with self._mu:
            row = self._deps.get(str(model))
            if row is None:
                return
            row["generations"] += 1
            if row["state"] == LOADING:
                row["state"] = WARM

    def drain(self, model: str) -> bool:
        """Start draining: in-flight sessions finish (the bindings stay
        resolvable) but the published state removes this replica from
        NEW placements."""
        with self._mu:
            row = self._deps.get(str(model))
            if row is None:
                return False
            row["state"] = DRAINING
            return True

    def undeploy(self, model: str) -> bool:
        with self._mu:
            return self._deps.pop(str(model), None) is not None

    def get(self, model: str) -> Optional[dict]:
        with self._mu:
            row = self._deps.get(str(model))
            return dict(row) if row is not None else None

    def resolve(self, model: Optional[str]) -> tuple[str, dict]:
        """The binding a request for ``model`` should run on.  ``None``
        (a model-less request) resolves to the sole deployment, or the
        default one when several are bound.  Raises ``KeyError`` on an
        unknown model or an unresolvable model-less request — the
        caller's misroute/EREQUEST path."""
        with self._mu:
            if model:
                row = self._deps.get(str(model))
                if row is None:
                    raise KeyError(f"unknown model {model!r}")
                return str(model), row
            if len(self._deps) == 1:
                k = next(iter(self._deps))
                return k, self._deps[k]
            row = self._deps.get(DEFAULT_MODEL)
            if row is not None:
                return DEFAULT_MODEL, row
            raise KeyError(
                f"model-less request but {len(self._deps)} deployments "
                f"bound and none is {DEFAULT_MODEL!r}")

    def keys(self) -> list[str]:
        with self._mu:
            return sorted(self._deps)

    def __len__(self) -> int:
        with self._mu:
            return len(self._deps)

    def snapshot(self) -> list[dict]:
        """The publication rows (no binding objects — wire-safe)."""
        with self._mu:
            return [{"model": r["model"], "model_id": r["model_id"],
                     "version": r["version"], "state": r["state"],
                     "weight": r["weight"],
                     "generations": r["generations"]}
                    for r in self._deps.values()]


class ModelCatalog:
    """Router-side view of the fleet's deployments: ``replica addr ->
    {model key -> publication row}``, folded from in-process
    :class:`ReplicaDeployments` handles and from the ``deployments``
    field remote ``_cluster`` replies carry.  Everything the admission
    path (resolve/canary) and the failover path (same-model constraint)
    need is answered here without an RPC."""

    def __init__(self):
        self._mu = InstrumentedLock("modelplane.catalog")
        self._by_addr: dict[str, dict[str, dict]] = {}

    def note(self, addr: str, rows: Sequence[dict]) -> None:
        """Fold one replica's publication (full-state: rows REPLACE the
        replica's previous entry, so an undeploy is visible as
        absence)."""
        parsed = {}
        for r in rows or ():
            try:
                key = str(r["model"])
            except (TypeError, KeyError):
                continue
            mid, ver = split_deployment_key(key)
            parsed[key] = {
                "model": key,
                "model_id": str(r.get("model_id") or mid),
                "version": str(r.get("version") or ver),
                "state": str(r.get("state") or WARM),
                "weight": max(1, int(r.get("weight") or 1)),
                "generations": int(r.get("generations") or 0)}
        with self._mu:
            self._by_addr[str(addr)] = parsed

    def forget(self, addr: str) -> None:
        with self._mu:
            self._by_addr.pop(str(addr), None)

    def empty(self) -> bool:
        with self._mu:
            return not any(self._by_addr.values())

    def keys(self) -> list[str]:
        with self._mu:
            out = set()
            for deps in self._by_addr.values():
                out.update(deps)
            return sorted(out)

    def has(self, model: str) -> bool:
        model = str(model)
        with self._mu:
            return any(model in deps for deps in self._by_addr.values())

    def replicas_for(self, model: str, *,
                     for_new: bool = True) -> list[str]:
        """Replicas serving ``model``: warm first, then loading.  With
        ``for_new`` (placements for new/failed-over work) draining
        replicas are excluded — they only finish what they already
        hold."""
        model = str(model)
        warm, loading, draining = [], [], []
        with self._mu:
            for addr, deps in self._by_addr.items():
                row = deps.get(model)
                if row is None:
                    continue
                {WARM: warm, LOADING: loading,
                 DRAINING: draining}.get(row["state"], loading).append(addr)
        out = warm + loading
        if not for_new:
            out += draining
        return out

    def resolve(self, model: str) -> list[str]:
        """Deployment KEYS matching ``model``: the exact key when one
        exists (an explicitly versioned request is never widened), else
        every versioned key of the bare ``model_id`` (the canary set).
        Empty for an unknown model."""
        model = str(model)
        with self._mu:
            exact = any(model in deps for deps in self._by_addr.values())
            if exact:
                return [model]
            keys = set()
            for deps in self._by_addr.values():
                for key, row in deps.items():
                    if row["model_id"] == model:
                        keys.add(key)
        return sorted(keys)

    def version_weights(self, model_id: str) -> dict[str, int]:
        """Canary weights per deployment key of ``model_id`` — the MAX
        published weight across replicas (weights are a property of the
        version, not the replica)."""
        model_id = str(model_id)
        out: dict[str, int] = {}
        with self._mu:
            for deps in self._by_addr.values():
                for key, row in deps.items():
                    if row["model_id"] == model_id \
                            and row["state"] != DRAINING:
                        out[key] = max(out.get(key, 0), row["weight"])
        return out

    def sole_key(self) -> Optional[str]:
        ks = self.keys()
        return ks[0] if len(ks) == 1 else None

    def snapshot(self) -> dict[str, list[dict]]:
        with self._mu:
            return {addr: [dict(r) for r in deps.values()]
                    for addr, deps in self._by_addr.items()}


class CanarySplit:
    """Deterministic smooth weighted round-robin across the versions of
    one ``model_id`` — nginx's smooth-WRR, the same behavior class as
    the weighted round-robin balancer: over any window of N picks each
    version receives ``N * w_i / sum(w)`` ± 1, so a 95/5 target lands
    within the acceptance band without randomness."""

    def __init__(self):
        self._mu = InstrumentedLock("modelplane.canary")
        self._cur: dict[str, dict[str, int]] = {}    # model_id -> key -> current
        self._picks: dict[str, dict[str, int]] = {}  # model_id -> key -> count

    def pick(self, model_id: str, weights: dict[str, int]) -> str:
        if not weights:
            raise ValueError(f"no versions to pick for {model_id!r}")
        model_id = str(model_id)
        with self._mu:
            cur = self._cur.setdefault(model_id, {})
            # drop versions that disappeared (undeployed canary)
            for k in list(cur):
                if k not in weights:
                    del cur[k]
            total = 0
            for k, w in weights.items():
                w = max(1, int(w))
                cur[k] = cur.get(k, 0) + w
                total += w
            best = max(sorted(cur), key=lambda k: cur[k])
            cur[best] -= total
            picks = self._picks.setdefault(model_id, {})
            picks[best] = picks.get(best, 0) + 1
            return best

    def snapshot(self) -> dict:
        with self._mu:
            return {m: dict(p) for m, p in self._picks.items()}


class ModelMetrics:
    """Per-deployment-key serving counters — the canary's scoreboard:
    sessions/sheds/finishes plus bounded TTFT and inter-token-latency
    reservoirs (percentiles computed at snapshot; the rings are small
    enough that /cluster can render them every poll)."""

    RESERVOIR = 512

    def __init__(self):
        self._mu = InstrumentedLock("modelplane.metrics")
        self._rows: dict[str, dict] = {}

    def _row(self, model: str) -> dict:
        r = self._rows.get(model)
        if r is None:
            r = {"sessions": 0, "sheds": 0, "finished": 0, "failed": 0,
                 "ttft_s": deque(maxlen=self.RESERVOIR),
                 "itl_s": deque(maxlen=self.RESERVOIR)}
            self._rows[model] = r
        return r

    def note_open(self, model: str) -> None:
        with self._mu:
            self._row(str(model))["sessions"] += 1

    def note_shed(self, model: str) -> None:
        with self._mu:
            self._row(str(model))["sheds"] += 1

    def note_ttft(self, model: str, seconds: float) -> None:
        with self._mu:
            self._row(str(model))["ttft_s"].append(float(seconds))

    def note_itl(self, model: str, seconds: float) -> None:
        with self._mu:
            self._row(str(model))["itl_s"].append(float(seconds))

    def note_finish(self, model: str, error_code: int = 0) -> None:
        with self._mu:
            r = self._row(str(model))
            r["failed" if error_code else "finished"] += 1

    @staticmethod
    def _pcts(xs) -> dict:
        if not xs:
            return {"n": 0, "p50_ms": None, "p99_ms": None}
        s = sorted(xs)
        n = len(s)
        return {"n": n,
                "p50_ms": round(s[min(n - 1, int(0.50 * n))] * 1e3, 3),
                "p99_ms": round(s[min(n - 1, int(0.99 * n))] * 1e3, 3)}

    def snapshot(self) -> dict:
        with self._mu:
            out = {}
            for m, r in self._rows.items():
                out[m] = {"sessions": r["sessions"],
                          "sheds": r["sheds"],
                          "finished": r["finished"],
                          "failed": r["failed"],
                          "ttft": self._pcts(r["ttft_s"]),
                          "itl": self._pcts(r["itl_s"])}
            return out


def publish_deployments(deps: Optional[ReplicaDeployments]) -> Optional[str]:
    """The ``deployments`` field a ``_cluster`` reply carries: the
    snapshot as one inline JSON string (tensorframe str fields cap at
    1 MiB — thousands of deployments before it matters)."""
    if deps is None:
        return None
    return json.dumps(deps.snapshot(), separators=(",", ":"))


def parse_deployments(field) -> Optional[list[dict]]:
    """Decode a ``deployments`` reply field; ``None`` on absence or any
    malformed payload (an old replica's reply simply lacks it)."""
    if not field:
        return None
    try:
        rows = json.loads(field)
    except (TypeError, ValueError):
        return None
    return rows if isinstance(rows, list) else None


def cluster_deploy(addr: str, *, epoch: int, model: str,
                   op: str = "deploy", weight: int = 1,
                   state: Optional[str] = None,
                   timeout_ms: int = 2_000) -> dict:
    """Push one lifecycle RPC (``deploy``/``undeploy``/``drain``) to a
    replica's ``_cluster`` service.  Carries the caller's membership
    epoch — a stale epoch is REFUSED exactly like a stale floor push
    (the superseded-router fence covers the catalog too).  Raises
    RpcError on refusal or transport failure."""
    from ..rpc.channel import control_channel
    method = {"deploy": "Deploy", "undeploy": "Undeploy",
              "drain": "Drain"}.get(op)
    if method is None:
        raise ValueError(f"unknown deploy op {op!r}")
    req = {"epoch": int(epoch), "model": str(model)}
    if op == "deploy":
        req["weight"] = max(1, int(weight))
        if state is not None:
            req["state"] = str(state)
    ch = control_channel(str(addr), int(timeout_ms))
    return ch.call_sync("_cluster", method, req,
                        serializer="tensorframe",
                        response_serializer="tensorframe")


__all__ = [
    "DEFAULT_MODEL", "LOADING", "WARM", "DRAINING",
    "deployment_key", "split_deployment_key", "model_fingerprint",
    "ReplicaDeployments", "ModelCatalog", "CanarySplit", "ModelMetrics",
    "publish_deployments", "parse_deployments", "cluster_deploy",
]
