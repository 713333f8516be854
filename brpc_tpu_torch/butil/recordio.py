"""recordio -- length-prefixed, checksummed record files (a copy of
``brpc_tpu/butil/recordio.py``, the same framing byte for byte).

Record layout (little-endian):
  u32 magic "RIO1" | u32 meta_len | u64 body_len | u32 crc32(meta+body)
  meta bytes | body bytes

A reader skips to the next magic on corruption, so a truncated tail or
a damaged record loses only itself.  Written by ``rpc/rpc_dump.py`` (one
request a record) and by the rpcz span database (one span a record).
"""
from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, Optional

MAGIC = b"RIO1"
_HDR = struct.Struct("<4sIQI")


class RecordWriter:
    def __init__(self, fp: BinaryIO):
        self._fp = fp

    def write(self, body: bytes, meta: bytes = b"") -> None:
        crc = zlib.crc32(meta) & 0xFFFFFFFF
        crc = zlib.crc32(body, crc) & 0xFFFFFFFF
        self._fp.write(_HDR.pack(MAGIC, len(meta), len(body), crc))
        if meta:
            self._fp.write(meta)
        if body:
            self._fp.write(body)

    def flush(self) -> None:
        self._fp.flush()


class RecordReader:
    def __init__(self, fp: BinaryIO):
        self._fp = fp

    def read(self) -> Optional[tuple[bytes, bytes]]:
        """``(meta, body)``, or None at the end.  A damaged record loses
        only itself: when its length fields may be the damage, the read
        rewinds to just past its magic and scans for the next one
        (trusting a lying length would swallow the following record or
        run into the end of the file)."""
        while True:
            start = self._fp.tell()
            hdr = self._fp.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return None
            magic, meta_len, body_len, crc = _HDR.unpack(hdr)
            if magic != MAGIC:
                if not self._resync(hdr):
                    return None
                continue
            try:
                meta = self._fp.read(meta_len)
                body = self._fp.read(body_len)
            except (OverflowError, MemoryError):
                # a damaged u64 length can exceed Py_ssize_t
                if not self._recover(start):
                    return None
                continue
            if len(meta) < meta_len or len(body) < body_len:
                # a torn tail or a lying length: rescan past this magic;
                # a true tail finds no further magic and ends the file
                if not self._recover(start):
                    return None
                continue
            got = zlib.crc32(meta) & 0xFFFFFFFF
            got = zlib.crc32(body, got) & 0xFFFFFFFF
            if got == crc:
                return meta, body
            # A damaged record.  When the frame still lines up (a magic
            # follows, or this was the last record) the lengths held and
            # the damage is in the payload: skip it whole.  Rescanning
            # from inside it would let MAGIC bytes in a payload (dump
            # bodies are raw wire bytes) surface as a made-up record.
            nxt = self._fp.read(len(MAGIC))
            if nxt == MAGIC:
                self._fp.seek(-len(MAGIC), 1)
                continue
            if len(nxt) < len(MAGIC):
                return None     # the damaged record was the tail
            if not self._recover(start):
                return None

    def _recover(self, start: int) -> bool:
        """Rewind to just past the failed record's magic and scan for
        the next one."""
        self._fp.seek(start + len(MAGIC))
        return self._resync(b"")

    def _resync(self, tail: bytes) -> bool:
        """Scan forward for the next magic and leave the file there.
        Callers guarantee the scan cannot find the record that just
        failed; the 3-byte carry catches a magic split across two
        chunk reads."""
        buf = tail
        while True:
            idx = buf.find(MAGIC)
            if idx >= 0:
                self._fp.seek(-len(buf[idx:]), 1)
                return True
            chunk = self._fp.read(65536)
            if not chunk:
                return False
            buf = buf[-3:] + chunk

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        while True:
            r = self.read()
            if r is None:
                return
            yield r
