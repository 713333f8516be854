"""Paged KV cache: refcounted pages over the device block pool, a radix
prefix tree, and the engine-facing store.

Every live store registers here, weakly and by name, so a console can
list their stats without keeping a closed store alive.
"""
import weakref

from ..butil.lockprof import InstrumentedLock

_reg_mu = InstrumentedLock("kvcache.registry")
_stores: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def _register_store(s) -> None:
    with _reg_mu:
        _stores[s.name] = s


def kvcache_snapshot() -> dict:
    """Live stores' stats, by name."""
    with _reg_mu:
        stores = dict(_stores)
    return {"stores": {name: s.stats()
                       for name, s in sorted(stores.items())}}


from .pages import KVPage, PagePool  # noqa: E402,F401
from .radix import RadixTree  # noqa: E402,F401
from .store import KVCacheStore, KVSeq, RecoveryPin  # noqa: E402,F401
