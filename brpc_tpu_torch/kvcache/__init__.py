"""Paged KV cache: refcounted pages over the device block pool, a radix
prefix tree, and the engine-facing store."""
from .pages import KVPage, PagePool  # noqa: F401
from .radix import RadixTree  # noqa: F401
from .store import KVCacheStore, KVSeq, RecoveryPin  # noqa: F401
