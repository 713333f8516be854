"""Adder and PassiveStatus (a copy of ``brpc_tpu/bvar/reducer.py``'s).

An Adder is write-local, combine-on-read: each writing thread adds into
its own cell (a ``threading.local``), a read sums the cells.
"""
from __future__ import annotations

import threading
from typing import Callable

from .variable import Variable


class _Cell:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


class Adder(Variable):
    """``adder << n``: a thread-local add, the sum on read."""

    def __init__(self, name: str = ""):
        self._tls = threading.local()
        self._cells: list = []
        self._mu = threading.Lock()
        super().__init__(name)

    def add(self, n=1):
        c = getattr(self._tls, "cell", None)
        if c is None:
            c = self._tls.cell = _Cell(0)
            with self._mu:
                self._cells.append(c)
        c.v += n
        return self

    def __lshift__(self, n):
        return self.add(n)

    def get_value(self):
        with self._mu:
            cells = list(self._cells)
        return sum(c.v for c in cells)


class PassiveStatus(Variable):
    """A variable whose value is a callback's."""

    def __init__(self, fn: Callable[[], object], name: str = ""):
        self._fn = fn
        super().__init__(name)

    def get_value(self):
        return self._fn()
