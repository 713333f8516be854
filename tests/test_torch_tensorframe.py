"""The port's tensorframe wire held against the JAX package's.

  * the same seeded fields encode to the same bytes in both packages:
    every kind, every dtype code, 0-d and empty tensors; CPU torch
    tensors encode as their numpy view does;
  * each package decodes the other's frames, to equal values;
  * both reject the same malformed frames with ``ValueError``
    (truncated, trailing bytes, 2**60 elements, an unknown dtype code, a
    bad magic);
  * a malformed frame sent to a live port server answers EREQUEST;
  * ``ScoreClient`` falls back to json, for good, on a server without
    ``ScoreT``.
"""
import struct
import time

import numpy as np
import pytest
import torch

import brpc_tpu.rpc.tensorframe as ref_tf
import brpc_tpu_torch.rpc as rpc
import brpc_tpu_torch.rpc.tensorframe as tf
from brpc_tpu_torch import errors
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.rpc.service import Service, method
from brpc_tpu_torch.serving import ScoreClient

# every wire dtype: (code, numpy dtype, torch dtype or None)
DTYPES = [(1, "<i8", torch.int64), (2, "<f4", torch.float32),
          (3, "<f8", torch.float64), (4, "<i4", torch.int32),
          (5, "|u1", torch.uint8), (6, "|b1", torch.bool),
          (7, "<u8", None), (8, "<f2", torch.float16)]
SHAPES = [(), (0,), (5,), (3, 4), (2, 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    """A client whose server this module stops marks that endpoint for
    the port's health check: retire the probes when the module ends."""
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


def _array(rng, dt, shape):
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, shape).astype(bool)
    if dt.kind in "iu":
        return rng.integers(0, 100, shape).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _fields(seed, dt):
    rng = np.random.default_rng(seed)
    out = {"i": int(rng.integers(-2**40, 2**40)), "f": float(rng.random()),
           "b": bool(rng.integers(0, 2)), "s": "héllo",
           "r": bytes(rng.integers(0, 256, 7, dtype=np.uint8))}
    for k, shape in enumerate(SHAPES):
        out[f"t{k}"] = _array(rng, dt, shape)
    return out


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k]


@pytest.mark.parametrize("code,dt,tdt", DTYPES)
def test_encode_bytes_equal_reference(code, dt, tdt):
    fields = _fields(code, dt)
    frame = tf.encode_frame(fields)
    assert frame == ref_tf.encode_frame(fields)
    # the field table names the closed-enum code
    assert frame[:4] == b"TFr1"
    if tdt is not None:
        as_torch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                    else v for k, v in fields.items()}
        assert tf.encode_frame(as_torch) == frame


@pytest.mark.parametrize("code,dt,tdt", DTYPES)
def test_each_package_decodes_the_others_frames(code, dt, tdt):
    fields = _fields(100 + code, dt)
    _same(tf.decode_frame(ref_tf.encode_frame(fields)), fields)
    _same(ref_tf.decode_frame(tf.encode_frame(fields)), fields)
    # decode gives views over the caller's buffer, no copy
    buf = bytearray(tf.encode_frame(fields))
    t = tf.decode_frame(memoryview(buf))["t2"]
    assert not t.flags.owndata


def test_both_refuse_a_multi_dim_empty_tensor_alike():
    """The reference encodes empty tensors of rank <= 1 only (its arena
    join casts a memoryview, which refuses a zero inside a shape of rank
    2 or more); the port keeps the same contract."""
    for shape in ((0, 3), (2, 0, 3)):
        for mod in (tf, ref_tf):
            with pytest.raises(TypeError):
                mod.encode_frame({"x": np.zeros(shape, np.float32)})


def test_encode_refuses_a_tensor_on_a_card():
    meta = torch.empty((2,), device="meta")
    with pytest.raises(TypeError):
        tf.encode_frame({"x": meta})


def _bad_frames():
    good = ref_tf.encode_frame({"x": np.arange(6, dtype=np.float32),
                                "n": 3})
    huge = (b"TFr1" + struct.pack("<B", 1) + struct.pack("<B", 1) + b"x"
            + struct.pack("<BBB", 6, 2, 1) + struct.pack("<Q", 2**60))
    unknown = (b"TFr1" + struct.pack("<B", 1) + struct.pack("<B", 1) + b"x"
               + struct.pack("<BBB", 6, 99, 1) + struct.pack("<Q", 1)
               + b"\0" * 8)
    return {"truncated": good[:-3], "trailing": good + b"\0",
            "2**60 elements": huge, "unknown dtype": unknown,
            "bad magic": b"TFr2" + good[4:], "empty": b"",
            "header cut": good[:9]}


@pytest.mark.parametrize("kind", sorted(_bad_frames()))
def test_both_reject_the_same_malformed_frames(kind):
    frame = _bad_frames()[kind]
    for mod in (tf, ref_tf):
        with pytest.raises(ValueError):
            mod.decode_frame(frame)


def test_malformed_frame_to_a_live_server_is_erequest():
    class Echo(Service):
        NAME = "Echo"

        @method(request="tensorframe", response="tensorframe")
        def Frame(self, cntl, req):
            return {"y": np.asarray(req["x"]) * 2}

    srv = rpc.Server()
    srv.add_service(Echo())
    srv.start("127.0.0.1", 0)
    try:
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10_000)
        x = np.arange(4, dtype=np.float32)
        out = ch.call_sync("Echo", "Frame", {"x": x},
                           serializer="tensorframe")
        np.testing.assert_array_equal(out["y"], 2 * x)
        for kind, frame in sorted(_bad_frames().items()):
            with pytest.raises(errors.RpcError) as ei:
                ch.call_sync("Echo", "Frame", frame, serializer="raw",
                             response_serializer="raw")
            assert ei.value.code == errors.EREQUEST, kind
    finally:
        srv.stop()
        srv.join()


def test_score_client_falls_back_to_json_without_score_t():
    class OldServing(Service):
        """A server that predates ScoreT: json Score only."""
        NAME = "Serving"

        @method(request="json", response="json")
        def Score(self, cntl, req):
            return {"y": [2 * v for v in req["x"]]}

    srv = rpc.Server()
    srv.add_service(OldServing())
    srv.start("127.0.0.1", 0)
    try:
        cli = ScoreClient(rpc.Channel(f"127.0.0.1:{srv.port}",
                                      timeout_ms=10_000))
        for _ in range(2):
            y = cli.score(np.asarray([1.0, 2.5], np.float32))
            np.testing.assert_array_equal(y, [2.0, 5.0])
            assert y.dtype == np.float32
        assert cli.wire_mode == "json"
        assert cli.n_negotiation_fallbacks == 1     # sticky: asked once
    finally:
        srv.stop()
        srv.join()
