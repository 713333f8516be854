"""DoublyBufferedData -- read-mostly data with wait-free reads (a copy of
``brpc_tpu/butil/doubly_buffered.py``).

Reads are one attribute load of an immutable snapshot; writes copy,
modify and flip under a writer mutex.  Every load balancer reads its
server list through one.
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, initial: T):
        self._fg: T = initial
        self._mu = threading.Lock()

    def read(self) -> T:
        """Wait-free: returns the current immutable snapshot."""
        return self._fg

    def modify(self, fn: Callable[[T], T]) -> T:
        """Apply fn to a copy of the current value and flip.  fn must treat
        its input as read-only and return the new snapshot."""
        with self._mu:
            new = fn(self._fg)
            self._fg = new
            return new
