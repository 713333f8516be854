"""Container utilities (a copy of ``brpc_tpu/butil/containers.py``).

CaseIgnoredDict — the case_ignored_flat_map analog (reference
    butil/containers/case_ignored_flat_map.h, used by HttpHeader): a
    mapping with case-insensitive lookup that PRESERVES the original key
    casing on iteration, so proxied HTTP headers go back out the way they
    came in instead of lower-cased.

MRUCache — most-recently-used cache (reference butil/containers/
    mru_cache.h): bounded mapping evicting the least-recently-used entry.
    Backs the console router's route-resolution cache.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import MutableMapping


class CaseIgnoredDict(MutableMapping):
    """dict with case-insensitive str keys, original casing preserved.

    Non-string keys are passed through untouched (so it can hold e.g.
    pseudo-header tuples without surprises).
    """

    __slots__ = ("_data",)

    def __init__(self, items=None, **kw):
        # _data: canonical(lower) key -> (original_key, value)
        self._data = {}
        if items is not None:
            self.update(items)
        if kw:
            self.update(kw)

    @staticmethod
    def _canon(key):
        return key.lower() if isinstance(key, str) else key

    def __setitem__(self, key, value):
        self._data[self._canon(key)] = (key, value)

    def __getitem__(self, key):
        return self._data[self._canon(key)][1]

    def __delitem__(self, key):
        del self._data[self._canon(key)]

    def __contains__(self, key):
        return self._canon(key) in self._data

    def __iter__(self):
        for orig, _ in self._data.values():
            yield orig

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return f"CaseIgnoredDict({dict(self.items())!r})"

    def copy(self):
        return CaseIgnoredDict(self.items())


class MRUCache:
    """Bounded most-recently-used cache.

    get() refreshes recency; put() evicts the least-recently-used entry
    once `capacity` is exceeded.  Not thread-safe on its own — callers in
    concurrent contexts wrap operations or tolerate racy refreshes (the
    router's cache does: a stale miss just redoes the prefix scan).
    """

    __slots__ = ("capacity", "_data", "hits", "misses")

    _MISSING = object()

    def __init__(self, capacity: int = 128):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return default
        # refresh recency (move_to_end may race with an eviction from
        # another thread; a KeyError there means the entry just fell out)
        try:
            self._data.move_to_end(key)
        except KeyError:
            pass
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        self._data[key] = value
        try:
            self._data.move_to_end(key)
        except KeyError:
            pass
        while len(self._data) > self.capacity:
            try:
                self._data.popitem(last=False)
            except KeyError:
                break

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()
