"""The model deployment registry: the named manifest behind the model
plane (a copy of ``brpc_tpu/models/registry.py``).

A :class:`ModelDeployment` is the manifest of one ``(model_id,
version)``: how to build its runner (a zero-argument factory, so a
registration costs nothing until a replica deploys it) and the KV
geometry its store must be cut with (``page_tokens``,
``kv_bytes_per_token``, ...).  The :class:`DeploymentRegistry` is the
process-wide name table that the multi-model spin-up helpers and a
replica's :class:`~brpc_tpu_torch.serving.modelplane.ReplicaDeployments`
rows are built from.

The module imports neither ``torch`` nor a runner: factories are opaque
callables, so the control plane (router, WAL recovery, console) can read
the manifest without loading the model code.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..serving.modelplane import (DEFAULT_MODEL, deployment_key,
                                  split_deployment_key)


@dataclass
class ModelDeployment:
    """One named deployment manifest (see module docstring).

    ``runner_factory`` returns whatever the engine accepts as a model
    (a :class:`~brpc_tpu_torch.models.runner.ModelRunner` or a legacy step
    fn); ``weight`` is the canary weight of THIS version inside its
    ``model_id``; ``kv_geometry`` is advisory metadata the spin-up
    helpers cut stores with (``page_tokens``, ``kv_bytes_per_token``,
    ...)."""

    model_id: str
    version: str = ""
    runner_factory: Optional[Callable[[], object]] = None
    weight: int = 1
    kv_geometry: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return deployment_key(self.model_id, self.version)

    def build_runner(self):
        """Instantiate the deployment's model (None without a
        factory — a catalog-only deployment)."""
        return None if self.runner_factory is None \
            else self.runner_factory()

    def describe(self) -> dict:
        return {"model": self.key, "model_id": self.model_id,
                "version": self.version, "weight": max(1, int(self.weight)),
                "kv_geometry": dict(self.kv_geometry),
                "has_factory": self.runner_factory is not None,
                "meta": dict(self.meta)}


class DeploymentRegistry:
    """Thread-safe ``key -> ModelDeployment`` manifest table."""

    def __init__(self):
        self._mu = threading.Lock()
        self._deps: dict[str, ModelDeployment] = {}

    def register(self, dep: ModelDeployment) -> ModelDeployment:
        with self._mu:
            if dep.key in self._deps:
                raise ValueError(
                    f"deployment {dep.key!r} already registered; "
                    f"unregister it first to replace the manifest row")
            self._deps[dep.key] = dep
        return dep

    def unregister(self, key: str) -> bool:
        with self._mu:
            return self._deps.pop(str(key), None) is not None

    def get(self, key: str) -> Optional[ModelDeployment]:
        with self._mu:
            return self._deps.get(str(key))

    def resolve(self, model: Optional[str]) -> ModelDeployment:
        """Manifest lookup with the plane's resolution rules: ``None``
        means the sole registration (or the default model); a bare
        ``model_id`` with exactly one version resolves to it.  Raises
        ``KeyError`` otherwise — the caller's EREQUEST path."""
        with self._mu:
            if model:
                d = self._deps.get(str(model))
                if d is not None:
                    return d
                versions = [d for d in self._deps.values()
                            if d.model_id == str(model)]
                if len(versions) == 1:
                    return versions[0]
                raise KeyError(
                    f"unknown or ambiguous model {model!r} "
                    f"({len(versions)} versions registered)")
            if len(self._deps) == 1:
                return next(iter(self._deps.values()))
            d = self._deps.get(DEFAULT_MODEL)
            if d is not None:
                return d
            raise KeyError(
                f"model-less lookup over {len(self._deps)} "
                f"registrations and no {DEFAULT_MODEL!r}")

    def versions_of(self, model_id: str) -> list[ModelDeployment]:
        with self._mu:
            return sorted((d for d in self._deps.values()
                           if d.model_id == str(model_id)),
                          key=lambda d: d.key)

    def keys(self) -> list[str]:
        with self._mu:
            return sorted(self._deps)

    def __len__(self) -> int:
        with self._mu:
            return len(self._deps)

    def snapshot(self) -> list[dict]:
        with self._mu:
            deps = list(self._deps.values())
        return [d.describe() for d in deps]


# the process-wide manifest
_global_registry = DeploymentRegistry()


def global_registry() -> DeploymentRegistry:
    return _global_registry


__all__ = ["ModelDeployment", "DeploymentRegistry", "global_registry",
           "deployment_key", "split_deployment_key", "DEFAULT_MODEL"]
