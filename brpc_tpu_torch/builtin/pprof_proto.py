"""pprof protobuf profile encoder (a copy of
``brpc_tpu/builtin/pprof_proto.py``): the wire format ``go tool pprof``
fetches, so any server is a remote pprof target.

Hand-rolled protobuf wire encoding of the public profile.proto schema
(github.com/google/pprof/proto/profile.proto) -- pure bytes, no protoc:

  Profile:  sample_type=1  sample=2  location=4  function=5
            string_table=6  duration_nanos=10  period_type=11  period=12
  ValueType: type=1 unit=2         (string-table indices)
  Sample:    location_id=1 value=2 (location ids LEAF FIRST)
  Location:  id=1 line=4
  Line:      function_id=1 line=2
  Function:  id=1 name=2

Input is a collapsed-stack Counter ("frameA;frameB;..." root->leaf,
sample counts); every distinct frame string becomes one Function and
Location.  Output is gzip-compressed, as pprof fetches it over HTTP.
"""
from __future__ import annotations

import gzip


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _uint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _blob(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _packed_uints(field: int, values) -> bytes:
    body = b"".join(_varint(v) for v in values)
    return _blob(field, body)


def encode_profile(stacks: dict[str, int], period_ns: int,
                   duration_ns: int) -> bytes:
    """collapsed-stack counts -> gzipped profile.proto bytes."""
    strtab: list[bytes] = [b""]          # index 0 must be ""
    index: dict[str, int] = {"": 0}

    def sid(s: str) -> int:
        i = index.get(s)
        if i is None:
            i = index[s] = len(strtab)
            strtab.append(s.encode("utf-8", "replace"))
        return i

    func_ids: dict[str, int] = {}
    functions: list[bytes] = []
    locations: list[bytes] = []

    def loc_id(frame: str) -> int:
        fid = func_ids.get(frame)
        if fid is None:
            fid = func_ids[frame] = len(functions) + 1
            functions.append(_uint(1, fid) + _uint(2, sid(frame)))
            line = _uint(1, fid)                      # Line.function_id
            locations.append(_uint(1, fid) + _blob(4, line))
        return fid

    samples: list[bytes] = []
    for collapsed, count in stacks.items():
        frames = [f for f in collapsed.split(";") if f]
        if not frames:
            continue
        ids = [loc_id(f) for f in reversed(frames)]    # leaf first
        samples.append(_packed_uints(1, ids) +
                       _packed_uints(2, [count]))

    sample_type = _uint(1, sid("samples")) + _uint(2, sid("count"))
    period_type = _uint(1, sid("cpu")) + _uint(2, sid("nanoseconds"))

    out = [_blob(1, sample_type)]
    out += [_blob(2, s) for s in samples]
    out += [_blob(4, loc) for loc in locations]
    out += [_blob(5, fn) for fn in functions]
    out += [_blob(6, s) for s in strtab]
    out.append(_uint(10, max(0, duration_ns)))
    out.append(_blob(11, period_type))
    out.append(_uint(12, max(1, period_ns)))
    return gzip.compress(b"".join(out), compresslevel=6)


# ---- minimal decoder (tests + /pprof self-checks) ----

def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if off >= len(buf) or shift > 63:
            raise ValueError("truncated or oversized varint")
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


def decode_profile(data: bytes) -> dict:
    """Gzipped profile.proto -> {string_table, samples:[(loc_ids,[v])],
    functions:{id:name_idx}, period}.  Enough structure to assert on."""
    buf = gzip.decompress(data)
    out = {"string_table": [], "samples": [], "functions": {},
           "locations": {}, "period": 0}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
            if field == 12:
                out["period"] = v
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            if off + ln > len(buf):
                raise ValueError("length-delimited field overruns buffer")
            payload = buf[off:off + ln]
            off += ln
            if field == 6:
                out["string_table"].append(payload.decode("utf-8"))
            elif field == 2:
                out["samples"].append(_decode_sample(payload))
            elif field == 5:
                fid, name = _decode_function(payload)
                out["functions"][fid] = name
            elif field == 4:
                lid, fid = _decode_location(payload)
                out["locations"][lid] = fid
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return out


def _decode_sample(p: bytes):
    locs, vals = [], []
    off = 0
    while off < len(p):
        key, off = _read_varint(p, off)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, off = _read_varint(p, off)
            end = off + ln
            while off < end:
                v, off = _read_varint(p, off)
                (locs if field == 1 else vals).append(v)
        else:
            v, off = _read_varint(p, off)
            (locs if field == 1 else vals).append(v)
    return locs, vals


def _decode_function(p: bytes):
    fid = name = 0
    off = 0
    while off < len(p):
        key, off = _read_varint(p, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(p, off)
            if field == 1:
                fid = v
            elif field == 2:
                name = v
        else:
            ln, off = _read_varint(p, off)
            off += ln
    return fid, name


def _decode_location(p: bytes):
    lid = fid = 0
    off = 0
    while off < len(p):
        key, off = _read_varint(p, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(p, off)
            if field == 1:
                lid = v
        elif wire == 2:
            ln, off = _read_varint(p, off)
            inner = p[off:off + ln]
            off += ln
            if field == 4:
                ioff = 0
                while ioff < len(inner):
                    k2, ioff = _read_varint(inner, ioff)
                    if k2 & 7 == 0:
                        v2, ioff = _read_varint(inner, ioff)
                        if k2 >> 3 == 1:
                            fid = v2
                    else:
                        ln2, ioff = _read_varint(inner, ioff)
                        ioff += ln2
    return lid, fid
