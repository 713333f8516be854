"""ctypes bindings to the port's native host core.

A copy of the part of ``brpc_tpu/_core/lib.py`` the port uses: the
socket, framing, timer and IOBuf entry points of the TRPC transport
and of the HTTP client (``brpc_connect``, raw-mode sockets), the
counters the builtin console reads,
the latency recorder of ``bvar``, the serving hot path's native emit
rings (:class:`TokenRing`), batch pad and page-table fill in
``libbrpc_core_torch.so``, and the ``_fastrpc`` extension linked
against it (its ``batch_pad``, ``page_table_fill``, ``tokring_push``
and span queue ``spanq_*``), both built by :mod:`.build` at the first
:func:`load`.
The port never opens the JAX package's ``libbrpc_core.so``; the two cores may
live in one process, each with its own executor, dispatchers, timer
thread and socket pool.
"""
from __future__ import annotations

import ctypes
import importlib.util
import sys
import threading

from . import build as _build

MSG_TRPC = 0
MSG_HTTP = 1
MSG_RAW = 7      # a raw-mode socket: every read is delivered as it comes

# Callback signatures (src/cc/capi.cc).  meta is c_void_p, not
# c_char_p: it is binary and may hold NULs; read it with string_at.
MESSAGE_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_void_p, ctypes.c_void_p)
FAILED_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_int,
                             ctypes.c_void_p)
ACCEPTED_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_uint64,
                               ctypes.c_void_p)
TASK_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
RESPONSE_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p)

_SIGS = {
    "brpc_core_init": (None, [ctypes.c_int, ctypes.c_int]),
    "brpc_snappy_max_compressed_length": (ctypes.c_size_t,
                                          [ctypes.c_size_t]),
    "brpc_snappy_compress": (ctypes.c_size_t,
                             [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_void_p]),
    "brpc_snappy_uncompressed_length": (ctypes.c_int64,
                                        [ctypes.c_char_p, ctypes.c_size_t]),
    "brpc_snappy_decompress": (ctypes.c_int,
                               [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_void_p, ctypes.c_size_t]),
    "brpc_iobuf_free": (None, [ctypes.c_void_p]),
    "brpc_iobuf_size": (ctypes.c_size_t, [ctypes.c_void_p]),
    "brpc_timer_add": (ctypes.c_uint64, [TASK_CB, ctypes.c_void_p,
                                         ctypes.c_int64]),
    "brpc_timer_cancel": (ctypes.c_int, [ctypes.c_uint64]),
    "brpc_socket_write_frame": (ctypes.c_int, [ctypes.c_uint64,
                                               ctypes.c_char_p,
                                               ctypes.c_size_t,
                                               ctypes.c_char_p,
                                               ctypes.c_size_t,
                                               ctypes.c_void_p]),
    "brpc_socket_write_raw": (ctypes.c_int, [ctypes.c_uint64,
                                             ctypes.c_char_p,
                                             ctypes.c_size_t,
                                             ctypes.c_void_p]),
    "brpc_socket_set_failed": (ctypes.c_int, [ctypes.c_uint64, ctypes.c_int]),
    "brpc_socket_alive": (ctypes.c_int, [ctypes.c_uint64]),
    "brpc_register_python_method": (None, [ctypes.c_char_p,
                                           ctypes.c_char_p]),
    "brpc_unregister_method": (ctypes.c_int, [ctypes.c_char_p,
                                              ctypes.c_char_p]),
    "brpc_listen_rpc": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                       MESSAGE_CB, FAILED_CB, ACCEPTED_CB,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_int)]),
    "brpc_connect_rpc": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                        MESSAGE_CB, FAILED_CB, RESPONSE_CB,
                                        ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64)]),
    # a plain client socket (the HTTP client's) and its wire protocol
    "brpc_connect": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                    MESSAGE_CB, FAILED_CB, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint64)]),
    "brpc_socket_set_protocol": (ctypes.c_int, [ctypes.c_uint64,
                                                ctypes.c_int]),
    # what the builtin console reads (/connections, /sockets, /bthreads,
    # /memory, /vlog)
    "brpc_socket_stats": (ctypes.c_int, [ctypes.c_uint64,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_char_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]),
    "brpc_socket_active_count": (ctypes.c_int64, []),
    "brpc_iobuf_live_blocks": (ctypes.c_int64, []),
    "brpc_iobuf_alloc_folded": (ctypes.c_int, [ctypes.c_char_p,
                                               ctypes.c_size_t]),
    "brpc_iobuf_alloc_events": (ctypes.c_int64, []),
    "brpc_executor_tasks_executed": (ctypes.c_int64, []),
    "brpc_executor_steals": (ctypes.c_int64, []),
    "brpc_executor_num_workers": (ctypes.c_int, []),
    "brpc_fiber_counters": (None, [ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]),
    "brpc_timer_fired": (ctypes.c_int64, []),
    "brpc_set_min_log_level": (None, [ctypes.c_int]),
    # bvar's native latency recorder (bvar/recorder.py)
    "brpc_latency_new": (ctypes.c_void_p, []),
    "brpc_latency_free": (None, [ctypes.c_void_p]),
    "brpc_latency_record": (None, [ctypes.c_void_p, ctypes.c_int64]),
    "brpc_latency_stats": (None, [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]),
    "brpc_latency_percentile": (ctypes.c_double, [ctypes.c_void_p,
                                                  ctypes.c_double]),
    # the serving hot path (src/cc/serving_hotpath.cc): bounded emit
    # token rings with batch push and pop, the batcher's formation pad,
    # the engine's page-table fill; each ctypes call releases the
    # interpreter lock
    "brpc_tokring_new": (ctypes.c_void_p, [ctypes.c_int]),
    "brpc_tokring_free": (None, [ctypes.c_void_p]),
    "brpc_tokring_live": (ctypes.c_int64, []),
    "brpc_tokring_push": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int32]),
    "brpc_tokring_push_many": (ctypes.c_int,
                               [ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int,
                                ctypes.POINTER(ctypes.c_uint8)]),
    "brpc_tokring_push_terminal": (ctypes.c_int, [ctypes.c_void_p,
                                                  ctypes.c_int32]),
    "brpc_tokring_pop_many": (ctypes.c_int,
                              [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int32)]),
    "brpc_tokring_size": (ctypes.c_int64, [ctypes.c_void_p]),
    "brpc_batch_pad": (None, [ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int64]),
    "brpc_page_table_fill": (None, [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int]),
}

_mu = threading.Lock()
core = None        # the ctypes handle, once load() ran
fastrpc = None     # the _fastrpc module, once load() ran


def load():
    """Build (where missing) and open the port's core and its
    ``_fastrpc`` extension, then start the core's executor, dispatchers
    and timer thread.  Idempotent; returns ``(core, fastrpc)``."""
    global core, fastrpc
    with _mu:
        if core is None:
            out = _build.build()
            lib = ctypes.CDLL(str(out / _build.LIB_NAME))
            for name, (res, args) in _SIGS.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            modname = __name__.rsplit(".", 1)[0] + "._fastrpc"
            spec = importlib.util.spec_from_file_location(
                modname, out / _build.EXT_NAME)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[modname] = mod
            # 0, 0: the core sizes its executor and epoll pool by CPU count
            lib.brpc_core_init(0, 0)
            core, fastrpc = lib, mod
        return core, fastrpc


class IOBuf:
    """An owned handle on a native chained buffer that the core handed
    to a callback (the message body); freed at garbage collection."""

    __slots__ = ("handle",)

    def __init__(self, handle: int):
        self.handle = handle

    def __del__(self):
        h = getattr(self, "handle", None)
        if h:
            core.brpc_iobuf_free(h)
            self.handle = None

    def __len__(self) -> int:
        return core.brpc_iobuf_size(self.handle)

    def to_bytes(self) -> bytes:
        return fastrpc.iobuf_bytes(self.handle, 0, -1)


class TokenRing:
    """One native bounded emit ring (``src/cc/serving_hotpath.cc``).
    The interpreter-lock choices are the reference's: :meth:`push`
    goes through ``_fastrpc.tokring_push``, which HOLDS the lock (the
    ring mutex is held for nanoseconds, so a release and reacquire per
    token would cost more than the push); the engine's one
    ``brpc_tokring_push_many`` per step and :meth:`pop_many` go through
    ctypes, which releases it.  The terminal's Python error OBJECT
    rides a wrapper slot set exactly once, before the native marker, so
    the emitter that sees the native terminal finds the winner's
    object in place."""

    __slots__ = ("handle", "cap", "_terminal_obj", "_terminal_set",
                 "_tmu")

    def __init__(self, cap: int):
        load()
        self.cap = int(cap)
        self.handle = core.brpc_tokring_new(self.cap)
        self._terminal_obj = None
        self._terminal_set = False
        # the terminal is once per request: a small Python lock keeps
        # the error object and the native marker exactly-once together;
        # the per-token path never takes it
        self._tmu = threading.Lock()

    def __del__(self):
        h = getattr(self, "handle", None)
        if h:
            core.brpc_tokring_free(h)
            self.handle = None

    def push(self, tok: int) -> bool:
        return bool(fastrpc.tokring_push(self.handle, tok))

    def push_terminal(self, err) -> None:
        with self._tmu:
            if self._terminal_set:
                return
            # the object BEFORE the native marker
            self._terminal_obj = err
            self._terminal_set = True
            core.brpc_tokring_push_terminal(
                self.handle, getattr(err, "code", 0) or 0)

    def pop_many(self, out, timeout_s: float):
        """Drain into the caller's ctypes int32 array `out`; returns
        ``(count, terminal_seen, err_obj)``."""
        term = ctypes.c_int(0)
        errc = ctypes.c_int32(0)
        n = core.brpc_tokring_pop_many(
            self.handle, out, len(out), int(timeout_s * 1e6),
            ctypes.byref(term), ctypes.byref(errc))
        return n, bool(term.value), self._terminal_obj

    def __len__(self) -> int:
        return core.brpc_tokring_size(self.handle)


def tokring_live() -> int:
    """Native emit rings alive in this process, on the port's core."""
    load()
    return core.brpc_tokring_live()
