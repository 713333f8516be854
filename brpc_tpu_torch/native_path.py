"""The serving hot path's native switchboard (a copy of
``brpc_tpu/native_path.py``).

The serving stack's native paths -- the engine's emit token rings and
page-table fill, the batcher's batch pad, rpcz's span queue -- all ask
HERE whether to take the native road.  The reloadable flag
``native_hot_path_enabled`` (default True) is a kill switch: off, each
of them takes its pure-Python path, with the same semantics and the
same streams and rows.  The flag is read per request, per batch and per
span, so flipping it live is safe: in-flight native rings keep draining
natively while new requests take the Python ``_EmitBuf``.

One deliberate difference from the reference: there a native core that
fails to build quietly degrades to the Python paths.  The port's core
(``_core/``, built from ``src/cc``) is already required by its RPC
front, so here a failed build RAISES; only the flag selects the Python
paths.  Nothing builds at import: the first native call loads (and
where missing builds) the core.
"""
from __future__ import annotations

from ._core import lib as _lib
from .flags import define_flag, get_flag

define_flag("native_hot_path_enabled", True,
            "serve the per-token hot path (emit rings, batch pad, page "
            "table fill, span queue) through the native core; off = the "
            "pure-Python paths with identical semantics", reloadable=True)


def enabled() -> bool:
    """The flag.  The native core is loaded at its first use, and a
    failed build raises there."""
    return bool(get_flag("native_hot_path_enabled", True))


def _fastrpc_mod():
    """The port's ``_fastrpc`` extension (loading the core)."""
    return _lib.load()[1]


def spanq():
    """The ``_fastrpc`` module holding the native span queue, or None
    when the flag sends spans through the collector."""
    return _fastrpc_mod() if enabled() else None


def token_ring(cap: int):
    """A native :class:`~._core.lib.TokenRing`, or None when the flag
    sends the request through the Python ``_EmitBuf``."""
    return _lib.TokenRing(cap) if enabled() else None


def tokring_live() -> int:
    """Native emit rings alive in this process (the leak baseline)."""
    return _lib.tokring_live()


def batch_pad(out, rows) -> None:
    """Zero-fill the 2-D C-contiguous numpy array ``out`` and copy each
    1-D C-contiguous array ``rows[i]`` of out.dtype into
    ``out[i, :len(rows[i])]`` (truncated to the row): one native call
    that releases the interpreter lock for the copy."""
    _fastrpc_mod().batch_pad(out, rows)


def page_table_fill(table, lists, slot_idx) -> None:
    """Fill the C-contiguous int32 ``table`` with -1 and copy each int32
    page-id array ``lists[k]`` into row ``slot_idx[k]`` (truncated to
    the table width): one native call that releases the interpreter
    lock for the fill."""
    _fastrpc_mod().page_table_fill(table, lists, slot_idx)


def flight_recorder():
    """The native flight recorder's surface (``butil/flight.py`` over
    ``src/cc/butil/flight.h``).  It observes the native core and has no
    Python counterpart, so the hot-path flag does not switch it; the
    flag ``flight_recorder_enabled`` does."""
    from .butil import flight
    return flight
