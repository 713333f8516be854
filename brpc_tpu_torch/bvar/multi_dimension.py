"""MultiDimension -- labelled metrics (a copy of
``brpc_tpu/bvar/multi_dimension.py``).

Maps label-value tuples to an underlying bvar (Adder, LatencyRecorder,
...): the Prometheus-label surface the ``/brpc_metrics`` page renders
as ``name{label="value",...}``."""
from __future__ import annotations

import threading
from typing import Callable

from .variable import Variable


class MultiDimension(Variable):
    def __init__(self, labels: list[str], make: Callable[[], Variable],
                 name: str = ""):
        self._labels = list(labels)
        self._make = make
        self._stats: dict[tuple, Variable] = {}
        self._mu = threading.Lock()
        super().__init__(name)

    def get_stats(self, *label_values) -> Variable:
        if len(label_values) != len(self._labels):
            raise ValueError(f"expected {len(self._labels)} labels")
        key = tuple(str(v) for v in label_values)
        with self._mu:
            v = self._stats.get(key)
            if v is None:
                v = self._make()
                self._stats[key] = v
            return v

    def delete_stats(self, *label_values) -> None:
        with self._mu:
            self._stats.pop(tuple(str(v) for v in label_values), None)

    def has_stats(self, *label_values) -> bool:
        with self._mu:
            return tuple(str(v) for v in label_values) in self._stats

    def count_stats(self) -> int:
        with self._mu:
            return len(self._stats)

    @property
    def labels(self):
        return list(self._labels)

    def items(self):
        with self._mu:
            return list(self._stats.items())

    def get_value(self):
        return {"/".join(k): v.get_value() for k, v in self.items()}
