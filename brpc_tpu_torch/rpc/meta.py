"""RpcMeta -- the per-frame TRPC metadata codec.

A copy of ``brpc_tpu/rpc/meta.py``: it encodes and decodes the same
bytes, so the port's server and channel speak to the JAX package's.

Layout (after the 16-byte TRPC frame header handled natively):
  u8 version | u8 msg_type | u16 flags | u64 correlation_id | u16 attempt
  then TLV: u8 tag | u32 len | bytes
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

MSG_REQUEST = 0
MSG_RESPONSE = 1
# streaming frames (§5.7) share the meta codec
MSG_STREAM_DATA = 2
MSG_STREAM_FEEDBACK = 3
MSG_STREAM_CLOSE = 4

# flags bits (u16 in the fixed header)
# rpcz head-sampling is decided ONCE at the trace root and inherited by
# every span of the trace; this bit carries the decision across the wire
# alongside T_TRACE_ID so a cascaded server keeps (or drops) the WHOLE
# trace instead of re-rolling per hop
FLAG_TRACE_SAMPLED = 0x0001

_FIXED = struct.Struct("<BBHQH")

# TLV tags
T_SERVICE = 1
T_METHOD = 2
T_ERROR_CODE = 3
T_ERROR_TEXT = 4
T_COMPRESS = 5
T_ATTACHMENT_SIZE = 6
T_TIMEOUT_MS = 7
T_TRACE_ID = 8
T_SPAN_ID = 9
T_PARENT_SPAN_ID = 10
T_USER_FIELD = 11
T_CONTENT_TYPE = 12
T_STREAM_ID = 13
T_STREAM_OFFSET = 14
T_TENSOR_HEADER = 15
T_AUTH = 16
T_STREAM_SEQ = 17

COMPRESS_NONE = 0
COMPRESS_GZIP = 1
COMPRESS_ZLIB = 2
COMPRESS_SNAPPY = 3  # native block-format codec (src/cc/butil/snappy.cc)
COMPRESS_ZSTD = 4

# Transport-reserved user-field keys (the rail ticket/source and the
# stream buffer exchange ride user_fields; caller-supplied fields must
# never collide).  The port reserves the same keys as the JAX package,
# the rail's among them, so a field one side refuses the other refuses
# too.
F_TICKET = "icit"
F_SRC_DEV = "icisrc"
F_SBUF = "sbuf"
# stream tensor-rail advertisement: the device id this side of a stream
# can RECEIVE tensor payloads on (StreamSettings exchange)
F_SDEV = "sdev"
RESERVED_USER_FIELD_KEYS = frozenset({F_TICKET, F_SRC_DEV, F_SBUF, F_SDEV})


def normalize_user_fields(fields: dict) -> dict:
    """ONE validation/normalization for caller-supplied user fields, both
    directions: keys must be str without NULs (a NUL corrupts the
    key\\0value TLV framing; bytes keys would be sent as reprs) and must
    not be transport-reserved; bytes values pass through, everything else
    is str()ed."""
    out = {}
    for k, v in (fields or {}).items():
        if not isinstance(k, str) or "\x00" in k:
            raise ValueError(
                f"user_fields key {k!r} must be a str without NUL bytes")
        if k in RESERVED_USER_FIELD_KEYS:
            raise ValueError(
                f"user_fields key {k!r} is reserved by the transport")
        out[k] = v if isinstance(v, (bytes, bytearray)) else str(v)
    return out


def strip_reserved_user_fields(fields: dict) -> dict:
    """Drop transport keys before surfacing received fields to callers."""
    return {k: v for k, v in (fields or {}).items()
            if k not in RESERVED_USER_FIELD_KEYS}


# constant byte prefixes of the stream-DATA fast encoder (all arguments
# are literals; packing them per message was pure waste on the hot path)
_STREAM_DATA_HDR = (_FIXED.pack(1, MSG_STREAM_DATA, 0, 0, 0)
                    + struct.pack("<BI", T_STREAM_ID, 8))
_STREAM_SEQ_TL = struct.pack("<BI", T_STREAM_SEQ, 8)


@dataclass(slots=True)
class RpcMeta:
    msg_type: int = MSG_REQUEST
    correlation_id: int = 0
    attempt: int = 0
    flags: int = 0
    service: str = ""
    method: str = ""
    error_code: int = 0
    error_text: str = ""
    compress_type: int = COMPRESS_NONE
    attachment_size: int = 0
    timeout_ms: int = 0
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    content_type: str = ""
    stream_id: int = 0
    stream_offset: int = 0
    stream_seq: int = 0
    tensor_header: bytes = b""
    auth: bytes = b""
    user_fields: dict = field(default_factory=dict)

    def encode(self) -> bytes:
        parts = [_FIXED.pack(1, self.msg_type, self.flags,
                             self.correlation_id, self.attempt)]

        def tlv(tag: int, payload: bytes):
            parts.append(struct.pack("<BI", tag, len(payload)))
            parts.append(payload)

        if self.service:
            tlv(T_SERVICE, self.service.encode())
        if self.method:
            tlv(T_METHOD, self.method.encode())
        if self.error_code:
            tlv(T_ERROR_CODE, struct.pack("<i", self.error_code))
        if self.error_text:
            tlv(T_ERROR_TEXT, self.error_text.encode())
        if self.compress_type:
            tlv(T_COMPRESS, bytes([self.compress_type]))
        if self.attachment_size:
            tlv(T_ATTACHMENT_SIZE, struct.pack("<Q", self.attachment_size))
        if self.timeout_ms:
            tlv(T_TIMEOUT_MS, struct.pack("<I", self.timeout_ms))
        if self.trace_id:
            tlv(T_TRACE_ID, struct.pack("<Q", self.trace_id))
        if self.span_id:
            tlv(T_SPAN_ID, struct.pack("<Q", self.span_id))
        if self.parent_span_id:
            tlv(T_PARENT_SPAN_ID, struct.pack("<Q", self.parent_span_id))
        if self.content_type:
            tlv(T_CONTENT_TYPE, self.content_type.encode())
        if self.stream_id:
            tlv(T_STREAM_ID, struct.pack("<Q", self.stream_id))
        if self.stream_offset:
            tlv(T_STREAM_OFFSET, struct.pack("<Q", self.stream_offset))
        if self.stream_seq:
            tlv(T_STREAM_SEQ, struct.pack("<Q", self.stream_seq))
        if self.tensor_header:
            tlv(T_TENSOR_HEADER, self.tensor_header)
        if self.auth:
            tlv(T_AUTH, self.auth)
        for k, v in self.user_fields.items():
            if isinstance(v, str):
                v = v.encode()
            tlv(T_USER_FIELD, k.encode() + b"\x00" + v)
        return b"".join(parts)

    @staticmethod
    def encode_stream_data(stream_id: int, seq: int) -> bytes:
        """Direct encoder for the stream-DATA shape: identical bytes to
        ``RpcMeta(msg_type=MSG_STREAM_DATA, stream_id=..,
        stream_seq=..).encode()`` without the generic encode."""
        parts = [_STREAM_DATA_HDR, struct.pack("<Q", stream_id)]
        if seq:
            parts.append(_STREAM_SEQ_TL)
            parts.append(struct.pack("<Q", seq))
        return b"".join(parts)

    @classmethod
    def decode(cls, data: bytes) -> "RpcMeta":
        if len(data) < _FIXED.size:
            raise ValueError("meta too short")
        ver, msg_type, flags, cid, attempt = _FIXED.unpack_from(data, 0)
        if ver != 1:
            raise ValueError(f"unknown meta version {ver}")
        m = cls(msg_type=msg_type, correlation_id=cid, attempt=attempt,
                flags=flags)
        off = _FIXED.size
        n = len(data)
        while off + 5 <= n:
            tag, ln = struct.unpack_from("<BI", data, off)
            off += 5
            if off + ln > n:
                raise ValueError("truncated TLV")
            p = data[off : off + ln]
            off += ln
            if tag == T_SERVICE:
                m.service = p.decode()
            elif tag == T_METHOD:
                m.method = p.decode()
            elif tag == T_ERROR_CODE:
                m.error_code = struct.unpack("<i", p)[0]
            elif tag == T_ERROR_TEXT:
                m.error_text = p.decode()
            elif tag == T_COMPRESS:
                m.compress_type = p[0]
            elif tag == T_ATTACHMENT_SIZE:
                m.attachment_size = struct.unpack("<Q", p)[0]
            elif tag == T_TIMEOUT_MS:
                m.timeout_ms = struct.unpack("<I", p)[0]
            elif tag == T_TRACE_ID:
                m.trace_id = struct.unpack("<Q", p)[0]
            elif tag == T_SPAN_ID:
                m.span_id = struct.unpack("<Q", p)[0]
            elif tag == T_PARENT_SPAN_ID:
                m.parent_span_id = struct.unpack("<Q", p)[0]
            elif tag == T_CONTENT_TYPE:
                m.content_type = p.decode()
            elif tag == T_STREAM_ID:
                m.stream_id = struct.unpack("<Q", p)[0]
            elif tag == T_STREAM_OFFSET:
                m.stream_offset = struct.unpack("<Q", p)[0]
            elif tag == T_STREAM_SEQ:
                m.stream_seq = struct.unpack("<Q", p)[0]
            elif tag == T_TENSOR_HEADER:
                m.tensor_header = p
            elif tag == T_AUTH:
                m.auth = p
            elif tag == T_USER_FIELD:
                k, _, v = p.partition(b"\x00")
                m.user_fields[k.decode()] = v
            # unknown tags skipped (forward compat)
        return m
