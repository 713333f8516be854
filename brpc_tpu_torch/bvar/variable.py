"""The bvar registry (a copy of ``brpc_tpu/bvar/variable.py``'s
``Variable``, ``exposed_variables``, ``find_exposed`` and
``dump_exposed``): every exposed variable by name, so a component can
hide exactly the names it exposed when it closes."""
from __future__ import annotations

import fnmatch
import threading
from typing import Optional

_registry: dict[str, "Variable"] = {}
_registry_lock = threading.Lock()


class Variable:
    """Base of every metric.  Subclasses implement get_value()."""

    def __init__(self, name: str = ""):
        self._name = ""
        if name:
            self.expose(name)

    def expose(self, name: str) -> "Variable":
        name = name.strip().replace(" ", "_")
        with _registry_lock:
            if self._name:
                _registry.pop(self._name, None)
            self._name = name
            _registry[name] = self
        return self

    def hide(self) -> None:
        with _registry_lock:
            if self._name:
                _registry.pop(self._name, None)
                self._name = ""

    @property
    def name(self) -> str:
        return self._name

    def get_value(self):
        raise NotImplementedError


def exposed_variables(pattern: str = "*") -> dict:
    """Exposed variable objects by name, for names matching the
    wildcard."""
    with _registry_lock:
        return {k: v for k, v in _registry.items()
                if fnmatch.fnmatch(k, pattern)}


def find_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(name)


def dump_exposed(pattern: str = "*") -> dict:
    """``{name: value}`` of the exposed variables matching the
    wildcard."""
    out = {}
    for name, var in exposed_variables(pattern).items():
        try:
            out[name] = var.get_value()
        except Exception as e:  # a broken callback must not break a dump
            out[name] = f"<error: {e}>"
    return out
