"""rpc_dump -- sampled capture of live requests into recordio files (a
copy of ``brpc_tpu/rpc/rpc_dump.py``); ``tools/rpc_replay.py`` sends
them again.

Flags (set at start-up, or with ``flags.set_flag(..., force=True)``):
  rpc_dump            -- the switch
  rpc_dump_dir        -- the directory of the ``.rdump`` files
  rpc_dump_ratio      -- keep one request of every N (1 = every one)
  rpc_dump_max_files  -- how many rotated files are kept
  rpc_dump_max_requests_in_one_file -- records a file holds

One record a request: meta = the request's wire ``RpcMeta`` bytes, body
= the payload as it arrived (compressed and serialized as the client
sent it), which is what a replay needs to send the call again byte for
byte.  The server's dispatch calls :meth:`RpcDumper.sample` only while
the ``rpc_dump`` flag is on; the file IO runs on the ``bvar`` collector
thread under the ``rpc_dump`` speed limit, never on the dispatch thread.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from .. import flags
from ..butil.recordio import RecordWriter
from ..bvar.collector import Collector, get_or_create_limit

RPC_DUMP = flags.define_flag("rpc_dump", False,
                             "sample incoming requests to recordio files")
flags.define_flag("rpc_dump_dir", "./rpc_dump", "directory for dump files")
flags.define_flag("rpc_dump_ratio", 1, "sample one of every N requests")
flags.define_flag("rpc_dump_max_files", 5, "max rotated dump files kept")
flags.define_flag("rpc_dump_max_requests_in_one_file", 10000,
                  "rotate after this many records")


class RpcDumper:
    _instance: Optional["RpcDumper"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "RpcDumper":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._mu = threading.Lock()
        self._counter = 0
        self._in_file = 0
        self._fp = None
        self._writer: Optional[RecordWriter] = None
        self._files: list[str] = []
        # the files' running index: the JAX package names a file by
        # len(self._files), which repeats once pruning starts, and a
        # repeated name within one second reopens (truncates) a kept file
        self._file_seq = 0

    def sample(self, meta_bytes: bytes, body) -> None:
        """One request from the server's dispatch: keep one of every
        ``rpc_dump_ratio``, then hand it to the collector.  The speed
        limit is asked before the body is copied, so a dropped sample
        costs no copy."""
        if not RPC_DUMP.value:
            return
        with self._mu:
            self._counter += 1
            ratio = max(1, int(flags.get_flag("rpc_dump_ratio")))
            if self._counter % ratio != 0:
                return
        if not get_or_create_limit("rpc_dump", 1000).grab():
            return
        Collector.instance().submit(_DumpSample(self, meta_bytes, body),
                                    family="rpc_dump")

    def _write_sample(self, meta_bytes: bytes, body: bytes) -> None:
        with self._mu:
            try:
                self._write_locked(meta_bytes, body)
            except OSError:
                pass  # dumping must never break serving

    def _write_locked(self, meta_bytes: bytes, body: bytes) -> None:
        limit = int(flags.get_flag("rpc_dump_max_requests_in_one_file"))
        if self._writer is None or self._in_file >= limit:
            self._rotate_locked()
        self._writer.write(body, meta_bytes)
        self._writer.flush()
        self._in_file += 1

    def _rotate_locked(self) -> None:
        if self._fp is not None:
            self._fp.close()
        d = str(flags.get_flag("rpc_dump_dir"))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"requests.{int(time.time())}.{os.getpid()}."
               f"{self._file_seq}.rdump")
        self._file_seq += 1
        self._fp = open(path, "wb")
        self._writer = RecordWriter(self._fp)
        self._in_file = 0
        self._files.append(path)
        max_files = int(flags.get_flag("rpc_dump_max_files"))
        while len(self._files) > max_files:
            old = self._files.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def close(self) -> None:
        """Write the records still queued on the collector, then close
        the current file; the next sample opens a new one."""
        Collector.instance().flush(family="rpc_dump")
        with self._mu:
            if self._fp is not None:
                self._fp.close()
                self._fp = None
                self._writer = None


class _DumpSample:
    """A collected request: written on the collector thread."""

    __slots__ = ("dumper", "meta", "body")

    def __init__(self, dumper: RpcDumper, meta: bytes, body):
        self.dumper = dumper
        self.meta = bytes(meta)
        # (the dispatch's buffer is copied here, on its own thread)
        to_bytes = getattr(body, "to_bytes", None)
        self.body = to_bytes() if to_bytes is not None else bytes(body)

    def dump_and_destroy(self) -> None:
        self.dumper._write_sample(self.meta, self.body)
