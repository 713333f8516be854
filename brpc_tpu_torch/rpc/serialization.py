"""Body serializers and compression.

The part of ``brpc_tpu/rpc/serialization.py`` the TRPC front needs,
encoding the same bytes:

  raw          opaque bytes
  json         dict/list/str/num as compact JSON
  tensorframe  inline scalars and strings plus tensors, decoded as numpy
               views (``rpc/tensorframe.py``)

Compression: gzip, zlib, snappy (the native block-format codec of the
port's core) and zstd where the ``zstandard`` package is installed.
The tensor, protobuf, pickle and compact serializers come with the
slices that use them.
"""
from __future__ import annotations

import ctypes
import gzip as _gzip
import json
import zlib as _zlib
from typing import Any

from . import meta as M

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None


class Serializer:
    name = "raw"

    def encode(self, obj: Any) -> tuple[bytes, bytes]:
        """Returns (body, tensor_header)."""
        raise NotImplementedError

    def decode(self, body: bytes, tensor_header: bytes) -> Any:
        raise NotImplementedError


def as_bytes(x):
    """IOBuf-backed memoryviews stay views through the transport's
    slicing and become bytes here, where handler code takes over."""
    return bytes(x) if isinstance(x, memoryview) else x


class RawSerializer(Serializer):
    name = "raw"

    def encode(self, obj):
        if isinstance(obj, (bytes, bytearray, memoryview)):
            return bytes(obj), b""
        if obj is None:
            return b"", b""
        raise TypeError(f"raw serializer needs bytes, got {type(obj)}")

    def decode(self, body, tensor_header):
        return as_bytes(body)


class JsonSerializer(Serializer):
    name = "json"

    def encode(self, obj):
        return json.dumps(obj, separators=(",", ":")).encode(), b""

    def decode(self, body, tensor_header):
        body = as_bytes(body)
        return json.loads(body) if body else None


class TensorFrameSerializer(Serializer):
    """Mixed-payload binary frames (see ``rpc/tensorframe.py`` for the
    layout and the bounded decode, whose ``ValueError`` the server maps
    to EREQUEST)."""

    name = "tensorframe"

    def encode(self, obj):
        from .tensorframe import encode_frame
        return encode_frame(obj), b""

    def decode(self, body, tensor_header):
        from .tensorframe import decode_frame
        return decode_frame(body)


_SERIALIZERS: dict[str, Serializer] = {
    s.name: s for s in (RawSerializer(), JsonSerializer(),
                        TensorFrameSerializer())}


def get_serializer(name):
    if isinstance(name, Serializer):
        return name
    s = _SERIALIZERS.get(name)
    if s is None:
        raise KeyError(f"unknown serializer {name!r}")
    return s


# ---- compression ----

def _core():
    from .._core import lib
    return lib.load()[0]


def snappy_compress(data) -> bytes:
    core = _core()
    data = bytes(data)
    if len(data) > 0xFFFFFFFF:
        raise ValueError("snappy length header is 32-bit; chunk upstream")
    buf = ctypes.create_string_buffer(
        core.brpc_snappy_max_compressed_length(len(data)))
    n = core.brpc_snappy_compress(data, len(data), buf)
    return ctypes.string_at(buf, n)


def snappy_decompress(data) -> bytes:
    core = _core()
    data = bytes(data)
    ulen = core.brpc_snappy_uncompressed_length(data, len(data))
    if ulen < 0:
        raise ValueError("malformed snappy header")
    # the densest legal element emits 64 bytes from 3: a larger claim is
    # hostile, refused before the allocation it was made to cause
    if ulen > len(data) * 22 + 64:
        raise ValueError("implausible snappy uncompressed length")
    buf = ctypes.create_string_buffer(max(int(ulen), 1))
    if core.brpc_snappy_decompress(data, len(data), buf, ulen) != 0:
        raise ValueError("malformed snappy body")
    return buf.raw[:ulen]


def _zstd_or_raise():
    if _zstd is None:
        raise ValueError("zstd not available in this environment")
    return _zstd


def compress(data: bytes, ctype: int) -> bytes:
    if ctype == M.COMPRESS_NONE or not data:
        return data
    if ctype == M.COMPRESS_GZIP:
        return _gzip.compress(data, compresslevel=1)
    if ctype == M.COMPRESS_ZLIB:
        return _zlib.compress(data, 1)
    if ctype == M.COMPRESS_SNAPPY:
        return snappy_compress(data)
    if ctype == M.COMPRESS_ZSTD:
        return _zstd_or_raise().ZstdCompressor(level=1).compress(data)
    raise ValueError(f"unknown compress type {ctype}")


def decompress(data: bytes, ctype: int) -> bytes:
    if ctype == M.COMPRESS_NONE or not data:
        return data
    if ctype == M.COMPRESS_GZIP:
        return _gzip.decompress(data)
    if ctype == M.COMPRESS_ZLIB:
        return _zlib.decompress(data)
    if ctype == M.COMPRESS_SNAPPY:
        # builds older than the native codec sent zstd frames under this
        # value; a zstd frame's magic can never start valid snappy
        if bytes(data[:4]) == b"\x28\xb5\x2f\xfd" and _zstd is not None:
            return _zstd.ZstdDecompressor().decompress(bytes(data))
        return snappy_decompress(data)
    if ctype == M.COMPRESS_ZSTD:
        return _zstd_or_raise().ZstdDecompressor().decompress(data)
    raise ValueError(f"unknown compress type {ctype}")
