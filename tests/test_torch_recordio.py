"""The port's recordio held against the JAX package's.

``brpc_tpu_torch/butil/recordio.py`` frames records as
``brpc_tpu/butil/recordio.py`` does, so the files cross both ways:

  * the same seeded records written by either package give the same
    bytes, and each package reads the other's file back byte-equal;
  * damage loses only the damaged record, in the same way in both
    readers: payload bit-rot (the frame still lines up), a lying length
    field (the reader rescans past the record's magic), a damaged
    record whose payload holds the magic (no record is made up from
    inside it), garbage between records;
  * a torn tail ends the file after the last whole record.
"""
import io
import struct

import numpy as np
import pytest

from brpc_tpu.butil import recordio as ref
from brpc_tpu_torch.butil import recordio as port

SEEDS = range(4)
HDR = struct.Struct("<4sIQI")


def _records(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        meta = rng.bytes(int(rng.integers(0, 40)))
        body = rng.bytes(int(rng.integers(0, 3000)))
        if i % 4 == 1:
            body = body[:10] + port.MAGIC + body[10:]  # magic in a payload
        out.append((meta, body))
    return out


def _write(mod, records) -> bytes:
    f = io.BytesIO()
    w = mod.RecordWriter(f)
    for meta, body in records:
        w.write(body, meta)
    w.flush()
    return f.getvalue()


def _read(mod, data: bytes) -> list:
    return list(mod.RecordReader(io.BytesIO(data)))


def _offsets(data: bytes, n: int) -> list:
    """Each record's start offset in a well-formed file."""
    offs, pos = [], 0
    for _ in range(n):
        offs.append(pos)
        _, ml, bl, _ = HDR.unpack_from(data, pos)
        pos += HDR.size + ml + bl
    return offs


@pytest.mark.parametrize("seed", SEEDS)
def test_files_are_byte_equal_and_cross_both_ways(seed):
    recs = _records(seed)
    mine, theirs = _write(port, recs), _write(ref, recs)
    assert mine == theirs
    assert _read(port, theirs) == recs
    assert _read(ref, mine) == recs
    assert port.MAGIC == ref.MAGIC and port._HDR.format == ref._HDR.format


@pytest.mark.parametrize("seed", SEEDS)
def test_files_on_disk_cross_both_ways(seed, tmp_path):
    recs = _records(seed, n=5)
    for writer, reader in ((port, ref), (ref, port)):
        path = tmp_path / f"{writer.__name__.split('.')[0]}.rio"
        with open(path, "wb") as f:
            w = writer.RecordWriter(f)
            for meta, body in recs:
                w.write(body, meta)
        with open(path, "rb") as f:
            assert list(reader.RecordReader(f)) == recs


def _damage(data: bytes, n: int, kind: str, seed: int) -> tuple[bytes, int]:
    """``data`` with one record damaged; returns it and the index lost."""
    rng = np.random.default_rng(100 + seed)
    offs = _offsets(data, n)
    k = int(rng.integers(1, n - 1))
    b = bytearray(data)
    start = offs[k]
    _, ml, bl, _ = HDR.unpack_from(data, start)
    if kind == "payload":
        if ml + bl:
            b[start + HDR.size + int(rng.integers(0, ml + bl))] ^= 0x40
        else:
            b[start + HDR.size - 1] ^= 0x40     # the crc itself
    elif kind == "length":
        # the body length lies: longer than the record, inside the file
        struct.pack_into("<Q", b, start + 8, bl + int(rng.integers(5, 900)))
    elif kind == "huge_length":
        struct.pack_into("<Q", b, start + 8, 2**63 + 7)
    elif kind == "magic_in_damaged_payload":
        k = 1                      # _records puts the magic in record 1
        start = offs[k]
        _, ml, bl, _ = HDR.unpack_from(data, start)
        b[start + HDR.size + ml + 2] ^= 0x01
    elif kind == "garbage_between":
        b[start:start] = rng.bytes(37)
        return bytes(b), -1
    return bytes(b), k


@pytest.mark.parametrize("kind", ["payload", "length", "huge_length",
                                  "magic_in_damaged_payload",
                                  "garbage_between"])
@pytest.mark.parametrize("seed", SEEDS)
def test_damage_loses_only_the_damaged_record(kind, seed):
    recs = _records(seed)
    data, lost = _damage(_write(port, recs), len(recs), kind, seed)
    want = [r for i, r in enumerate(recs) if i != lost]
    assert _read(port, data) == want
    assert _read(ref, data) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_torn_tail_ends_after_the_last_whole_record(seed):
    recs = _records(seed)
    data = _write(port, recs)
    last = _offsets(data, len(recs))[-1]
    rng = np.random.default_rng(200 + seed)
    for cut in (last + 1, last + HDR.size - 1, last + HDR.size + 1,
                int(rng.integers(last + 1, len(data)))):
        torn = data[:cut]
        assert _read(port, torn) == recs[:-1], cut
        assert _read(ref, torn) == recs[:-1], cut
    # 1-3 stray bytes after a damaged last record end the file too
    tail = bytearray(data)
    tail[last + HDR.size] ^= 0x10
    for extra in (b"R", b"RI", b"RIO"):
        assert _read(port, bytes(tail) + extra) == recs[:-1]
        assert _read(ref, bytes(tail) + extra) == recs[:-1]
