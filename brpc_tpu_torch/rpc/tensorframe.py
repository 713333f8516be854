"""tensorframe: the mixed-payload binary wire format (a copy of
``brpc_tpu/rpc/tensorframe.py``, byte for byte the same frames).

A self-framed binary body whose tensor bytes are DECODED AS VIEWS:
``np.frombuffer`` straight over the buffer the transport hands up.

Frame layout (little-endian throughout)::

    magic  b"TFr1"                      (4 bytes)
    u8     n_fields                     (<= MAX_FIELDS)
    per field:
      u8   name_len  (1..MAX_NAME), name bytes (ascii)
      u8   kind      1=int 2=float 3=bool 4=str 5=bytes 6=tensor
      int    -> <q        float -> <d        bool -> u8 (0|1)
      str    -> <I len (<= MAX_INLINE) + utf-8 bytes
      bytes  -> <I len (<= MAX_INLINE) + raw bytes
      tensor -> u8 dtype_code, u8 ndim (<= MAX_NDIM), ndim * <Q dims
    tensor arena: every tensor's C-order bytes, packed in field order,
    immediately after the field table.  The arena must be consumed
    EXACTLY -- trailing garbage is a malformed frame, not padding.

The decode is BOUNDED: every header read is bounds-checked, dtypes come
from a closed enum (never ``np.dtype(hostile_string)``), shape products
are computed in exact Python ints and checked against the remaining
arena BEFORE any allocation -- a frame claiming 2**60 elements raises
``ValueError`` without allocating a byte.  Malformed frames surface as
``ValueError``, which the server's decode phase maps to ``EREQUEST``.

Encoding takes numpy arrays and CPU torch tensors (the port's
counterpart of the reference's jax arrays, sent as their numpy view);
a tensor on a card raises ``TypeError`` -- moving it to the host is the
caller's decision.  Decoding gives numpy views.
"""
from __future__ import annotations

import struct
from typing import Any, Union

import numpy as np

import torch

from ..bvar import Adder

MAGIC = b"TFr1"

MAX_FIELDS = 64
MAX_NAME = 64
MAX_NDIM = 8
MAX_INLINE = 1 << 20          # inline str/bytes cap (tensors are arena)

KIND_INT = 1
KIND_FLOAT = 2
KIND_BOOL = 3
KIND_STR = 4
KIND_BYTES = 5
KIND_TENSOR = 6

# closed dtype enum: decode NEVER parses a dtype string off the wire
# (np.dtype(str) ast-parses some specs — the tensor-serializer fuzz
# target found SyntaxError paths in there)
_DTYPE_BY_CODE = {
    1: np.dtype("<i8"),
    2: np.dtype("<f4"),
    3: np.dtype("<f8"),
    4: np.dtype("<i4"),
    5: np.dtype("|u1"),
    6: np.dtype("|b1"),
    7: np.dtype("<u8"),
    8: np.dtype("<f2"),
}
_CODE_BY_DTYPE = {dt: c for c, dt in _DTYPE_BY_CODE.items()}

FRAME_ENCODES = Adder("tensorframe_encodes")
FRAME_DECODES = Adder("tensorframe_decodes")
# encode-side forced materializations beyond the single frame-assembly
# join (non-contiguous / byte-swapped arrays a caller snuck in); the
# loopback bench pins this at zero for the PS surface
FRAME_HOST_COPIES = Adder("tensorframe_host_copies")


def _tensor_code(a: np.ndarray) -> int:
    dt = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" \
        else a.dtype
    code = _CODE_BY_DTYPE.get(np.dtype(dt))
    if code is None:
        raise TypeError(
            f"tensorframe has no wire code for dtype {a.dtype}; "
            f"supported: {sorted(str(d) for d in _CODE_BY_DTYPE)}")
    return code


def _as_host_array(name, v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if v.device.type != "cpu":
        raise TypeError(f"tensor field {name!r} lives on {v.device}; "
                        f"tensorframe encodes host tensors")
    return v.detach().numpy()


def encode_frame(fields: dict) -> bytes:
    """One frame from ``{name: int|float|bool|str|bytes|ndarray}``.

    Kind is chosen from the Python type; numpy arrays and CPU torch
    tensors (any rank, including 0-d) take the tensor slot.  Returns
    the complete frame body (header + tensor arena) as one bytes
    object: a single join, no per-element conversion, no float64
    round-trip."""
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"{len(fields)} fields > MAX_FIELDS={MAX_FIELDS}")
    hdr: list[bytes] = [MAGIC, struct.pack("<B", len(fields))]
    arena: list = []
    for name, v in fields.items():
        nb = str(name).encode("ascii")
        if not 1 <= len(nb) <= MAX_NAME:
            raise ValueError(f"field name {name!r} length must be "
                             f"1..{MAX_NAME}")
        hdr.append(struct.pack("<B", len(nb)))
        hdr.append(nb)
        if isinstance(v, bool):          # before int: bool IS int
            hdr.append(struct.pack("<BB", KIND_BOOL, 1 if v else 0))
        elif isinstance(v, (int, np.integer)):
            hdr.append(struct.pack("<Bq", KIND_INT, int(v)))
        elif isinstance(v, (float, np.floating)):
            hdr.append(struct.pack("<Bd", KIND_FLOAT, float(v)))
        elif isinstance(v, str):
            b = v.encode("utf-8")
            if len(b) > MAX_INLINE:
                raise ValueError(f"str field {name!r} exceeds inline cap")
            hdr.append(struct.pack("<BI", KIND_STR, len(b)))
            hdr.append(b)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            b = bytes(v)
            if len(b) > MAX_INLINE:
                raise ValueError(f"bytes field {name!r} exceeds inline cap")
            hdr.append(struct.pack("<BI", KIND_BYTES, len(b)))
            hdr.append(b)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            v = _as_host_array(name, v)
            code = _tensor_code(v)
            if v.ndim > MAX_NDIM:
                raise ValueError(f"tensor field {name!r} ndim {v.ndim} > "
                                 f"{MAX_NDIM}")
            body = v
            if not body.flags.c_contiguous or \
                    body.dtype != _DTYPE_BY_CODE[code]:
                # the one place encode may copy: strided or big-endian
                # input (counted so the zero-copy claim stays testable)
                body = np.ascontiguousarray(body,
                                            dtype=_DTYPE_BY_CODE[code])
                FRAME_HOST_COPIES.add(1)
            hdr.append(struct.pack(f"<BBB{v.ndim}Q", KIND_TENSOR, code,
                                   v.ndim, *v.shape))
            # memoryview: the final join reads the array's buffer
            # directly — no .tobytes() materialization per tensor
            arena.append(memoryview(body).cast("B"))
        else:
            raise TypeError(f"field {name!r}: unsupported type {type(v)}")
    FRAME_ENCODES.add(1)
    return b"".join(hdr + arena)


class _Cursor:
    """Bounds-checked reader over the frame header."""

    __slots__ = ("buf", "off", "end")

    def __init__(self, buf, off: int, end: int):
        self.buf = buf
        self.off = off
        self.end = end

    def take(self, n: int):
        if self.off + n > self.end:
            raise ValueError("truncated tensorframe header")
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def unpack(self, fmt: str):
        n = struct.calcsize(fmt)
        if self.off + n > self.end:
            raise ValueError("truncated tensorframe header")
        out = struct.unpack_from(fmt, self.buf, self.off)
        self.off += n
        return out


def decode_frame(buf: Union[bytes, bytearray, memoryview]) -> dict:
    """Frame body -> ``{name: value}``.

    Tensor fields come back as numpy VIEWS over ``buf`` (zero copy —
    a memoryview straight off the transport stays pinned to its IOBuf
    blocks while any returned array references it).  Every malformed
    input raises ``ValueError`` with bounded allocation: header reads
    are bounds-checked and tensor byte counts are proven against the
    arena before any array object exists."""
    if isinstance(buf, memoryview):
        if buf.ndim != 1 or buf.itemsize != 1:
            buf = buf.cast("B")
    n = len(buf)
    if n < 5 or bytes(buf[:4]) != MAGIC:
        raise ValueError("not a tensorframe (bad magic)")
    cur = _Cursor(buf, 4, n)
    (n_fields,) = cur.unpack("<B")
    if n_fields > MAX_FIELDS:
        raise ValueError(f"{n_fields} fields > MAX_FIELDS={MAX_FIELDS}")
    out: dict[str, Any] = {}
    # pass 1 — walk the field table (inline values decode here; tensor
    # specs are recorded), bounding everything before arena math
    tensors: list[tuple[str, np.dtype, tuple, int]] = []
    arena_bytes = 0
    for _ in range(n_fields):
        (name_len,) = cur.unpack("<B")
        if not 1 <= name_len <= MAX_NAME:
            raise ValueError(f"field name length {name_len} out of "
                             f"1..{MAX_NAME}")
        try:
            name = bytes(cur.take(name_len)).decode("ascii")
        except UnicodeDecodeError as e:
            raise ValueError(f"non-ascii field name: {e}")
        if name in out or any(t[0] == name for t in tensors):
            raise ValueError(f"duplicate field {name!r}")
        (kind,) = cur.unpack("<B")
        if kind == KIND_INT:
            (out[name],) = cur.unpack("<q")
        elif kind == KIND_FLOAT:
            (out[name],) = cur.unpack("<d")
        elif kind == KIND_BOOL:
            (b,) = cur.unpack("<B")
            if b not in (0, 1):
                raise ValueError(f"bool field {name!r} byte {b} not 0|1")
            out[name] = bool(b)
        elif kind in (KIND_STR, KIND_BYTES):
            (ln,) = cur.unpack("<I")
            if ln > MAX_INLINE:
                raise ValueError(f"inline field {name!r} claims {ln} "
                                 f"bytes > cap {MAX_INLINE}")
            raw = bytes(cur.take(ln))
            if kind == KIND_STR:
                try:
                    out[name] = raw.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise ValueError(f"bad utf-8 in str field "
                                     f"{name!r}: {e}")
            else:
                out[name] = raw
        elif kind == KIND_TENSOR:
            code, ndim = cur.unpack("<BB")
            dt = _DTYPE_BY_CODE.get(code)
            if dt is None:
                raise ValueError(f"unknown tensor dtype code {code}")
            if ndim > MAX_NDIM:
                raise ValueError(f"tensor ndim {ndim} > {MAX_NDIM}")
            shape = cur.unpack(f"<{ndim}Q")
            # exact Python-int element count (np.prod silently wraps);
            # bound against the whole buffer BEFORE any allocation so
            # an absurd shape product can never drive an allocation
            cnt = 1
            for d in shape:
                cnt *= int(d)
            nbytes = cnt * dt.itemsize
            if arena_bytes + nbytes > n:
                raise ValueError(
                    f"tensor field {name!r} claims {cnt} x {dt} "
                    f"({nbytes} bytes) but frame holds {n} bytes")
            arena_bytes += nbytes
            tensors.append((name, dt, shape, nbytes))
        else:
            raise ValueError(f"unknown field kind {kind}")
    # pass 2 — the arena must match the declared tensors EXACTLY
    if n - cur.off != arena_bytes:
        raise ValueError(
            f"tensor arena is {n - cur.off} bytes, field table "
            f"declares {arena_bytes}")
    pos = cur.off
    for name, dt, shape, nbytes in tensors:
        cnt = nbytes // dt.itemsize if dt.itemsize else 0
        # zero copy: a view over the caller's buffer (read-only when
        # the buffer is), reshaped to the declared shape
        out[name] = np.frombuffer(buf, dtype=dt, count=cnt,
                                  offset=pos).reshape(shape)
        pos += nbytes
    FRAME_DECODES.add(1)
    return out
