"""Body serializers and compression.

The part of ``brpc_tpu/rpc/serialization.py`` the TRPC front needs,
encoding the same bytes:

  raw          opaque bytes
  json         dict/list/str/num as compact JSON
  tensor       numpy arrays as raw C-order bytes plus a dtype/shape
               header (the DCN envelope's array codec, ``ici/dcn.py``)
  tensorframe  inline scalars and strings plus tensors, decoded as numpy
               views (``rpc/tensorframe.py``)

Compression: gzip, zlib, snappy (the native block-format codec of the
port's core) and zstd where the ``zstandard`` package is installed.
The protobuf, pickle and compact serializers come with the slices that
use them.
"""
from __future__ import annotations

import ctypes
import gzip as _gzip
import json
import struct
import zlib as _zlib
from typing import Any

import numpy as np

from ..bvar import Adder
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


# host-side tensor encodes/decodes: a control-only DCN envelope never
# moves them
tensor_host_encodes = Adder("tensor_host_encodes")
tensor_host_decodes = Adder("tensor_host_decodes")


class TensorSerializer(Serializer):
    """ndarray <-> raw bytes + header.  Lists/tuples of arrays supported.

    Header: u8 single flag, u8 count, then per tensor: u8 dtype_len,
    dtype str, u8 ndim, ndim*u64 shape.  Bodies are concatenated C-order
    bytes.  The reference's bytes exactly, for the same arrays."""

    name = "tensor"

    def encode(self, obj):
        arrays = obj if isinstance(obj, (list, tuple)) else [obj]
        hdr = [struct.pack("<B", len(arrays))]
        bodies = []
        tensor_host_encodes.add(1)
        for a in arrays:
            a = np.asarray(a)
            dt = a.dtype.str.encode()
            hdr.append(struct.pack("<B", len(dt)) + dt)
            hdr.append(struct.pack("<B", a.ndim) +
                       struct.pack(f"<{a.ndim}Q", *a.shape))
            bodies.append(np.ascontiguousarray(a).tobytes())
        single = not isinstance(obj, (list, tuple))
        flag = b"\x01" if single else b"\x00"
        return b"".join(bodies), flag + b"".join(hdr)

    def decode(self, body, tensor_header):
        if not tensor_header:
            return body
        tensor_host_decodes.add(1)
        try:
            return self._decode_checked(body, tensor_header)
        except IndexError as e:
            # walking past a truncated header is bad input: every
            # malformed-header path raises ValueError
            raise ValueError(f"truncated tensor header: {e}")

    def _decode_checked(self, body, tensor_header):
        single = tensor_header[0] == 1
        off = 1
        count = tensor_header[off]
        off += 1
        out = []
        pos = 0
        for _ in range(count):
            dlen = tensor_header[off]
            off += 1
            try:
                dt = np.dtype(
                    tensor_header[off:off + dlen].decode("ascii"))
            except ValueError:
                raise
            except Exception as e:
                # np.dtype can raise SyntaxError, TypeError, ... on a
                # hostile spec string: bad input all the same
                raise ValueError(f"bad dtype in tensor header: {e}")
            off += dlen
            ndim = tensor_header[off]
            off += 1
            try:
                shape = struct.unpack_from(f"<{ndim}Q", tensor_header, off)
            except struct.error as e:
                raise ValueError(f"truncated tensor header: {e}")
            off += 8 * ndim
            # exact element count in Python ints, bounded by the body
            # before numpy sees it
            if dt.itemsize == 0:
                raise ValueError(f"zero-itemsize dtype {dt} in header")
            cnt = 1
            for d in shape:
                cnt *= int(d)
            if cnt * dt.itemsize > len(body) - pos:
                raise ValueError(
                    f"tensor header claims {cnt} x {dt} at offset {pos} "
                    f"but body has {len(body) - pos} bytes")
            arr = np.frombuffer(body, dtype=dt, count=cnt, offset=pos)
            out.append(arr.reshape(shape))
            pos += cnt * dt.itemsize
        return out[0] if single and out else out


_SERIALIZERS: dict[str, Serializer] = {
    s.name: s for s in (RawSerializer(), JsonSerializer(),
                        TensorSerializer(), TensorFrameSerializer())}


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
