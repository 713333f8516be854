"""The port's DCN handshake and envelope (``brpc_tpu_torch/ici/dcn.py``)
held against the JAX package's.

Counterparts of ``tests/test_dcn.py``'s handshake, bad-magic and
address-parsing tests, plus the wire pieces the KV migration plane
rides: ``_pack_envelope``/``_unpack_envelope`` and ``TensorSerializer``
give byte-equal output in both packages on seeded inputs, and refuse the
same malformed input; a port ``DcnChannel`` handshakes with a reference
``Server(enable_dcn=True)`` and the reverse.  The port has no transfer
fabric (``"xfer": null``) and no device-service registry yet, so
``CallDevice``/``call_sync`` answer ENOMETHOD naming ROADMAP item 8 (the
reference's device-call tests wait for it).  Bytes are compared exactly.
"""
import numpy as np
import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.ici import dcn as ref_dcn
from brpc_tpu.rpc import serialization as ref_ser
from brpc_tpu_torch import errors, rpc
from brpc_tpu_torch.ici import dcn
from brpc_tpu_torch.rpc import serialization as ser

DTYPES = ("<f4", "<f8", "<i4", "<i8", "u1", "<u8", "<f2", "?")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, dt in enumerate(DTYPES):
        shape = tuple(rng.integers(0, 5, i % 4).tolist())
        out.append((rng.standard_normal(shape) * 100).astype(dt))
    return out


@pytest.fixture(scope="module")
def port_server():
    srv = rpc.Server(enable_dcn=True, dcn_device="cpu")
    srv.start("127.0.0.1", 0)
    yield srv, f"127.0.0.1:{srv.port}"
    srv.stop()
    srv.join()


@pytest.fixture(scope="module")
def ref_server():
    srv = ref_rpc.Server(enable_dcn=True)
    srv.start("127.0.0.1", 0)
    yield srv, f"127.0.0.1:{srv.port}"
    srv.stop()
    srv.join()


@pytest.mark.parametrize("seed", range(3))
def test_tensor_serializer_bytes_equal_reference(seed):
    arrays = _arrays(seed)
    for obj in (arrays, tuple(arrays[:2]), arrays[0]):
        body, hdr = ser.TensorSerializer().encode(obj)
        rbody, rhdr = ref_ser.TensorSerializer().encode(obj)
        assert (body, hdr) == (rbody, rhdr)
        got = ser.TensorSerializer().decode(rbody, rhdr)
        got = got if isinstance(got, list) else [got]
        want = obj if isinstance(obj, (list, tuple)) else [obj]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_envelope_bytes_equal_reference(seed):
    rng = np.random.default_rng(10 + seed)
    header = {"svc": "S", "tokens": rng.integers(0, 2**31, 9).tolist(),
              "fingerprints": [int(x) for x in
                               rng.integers(0, 2**63, 3, dtype=np.uint64)],
              "nested": {"a": [1, 2.5, None, "x"]}}
    for arrays in (_arrays(seed), []):
        env = dcn._pack_envelope(header, arrays)
        assert env == ref_dcn._pack_envelope(header, arrays)
        hdr, got = dcn._unpack_envelope(env)
        assert hdr == header
        assert [a.tobytes() for a in got] == [a.tobytes() for a in arrays]


@pytest.mark.parametrize("data", [
    b"\x00" * 5,                                   # too short
    b"\xff\xff\xff\x00" + b"\x00" * 8,             # header bound
    b"\x02\x00\x00\x00{}" + b"\xff\x00\x00\x00",   # tensor header length
    b"\x02\x00\x00\x00{}\x05\x00\x00\x00\x01\x01\x03zz9\x00",  # bad dtype
    b"\x02\x00\x00\x00{}\x0d\x00\x00\x00\x01\x01\x03<f4\x01"
    b"\x10\x00\x00\x00\x00\x00\x00\x00",           # body shorter than shape
])
def test_unpack_refuses_what_the_reference_refuses(data):
    with pytest.raises(ValueError):
        ref_dcn._unpack_envelope(data)
    with pytest.raises(ValueError):
        dcn._unpack_envelope(data)


def test_parse_dcn_address_forms():
    for a in ("ici://h:80/3", "ici://h:80", "h:80", "ici://[::1]:9/0"):
        assert dcn.parse_dcn_address(a) == ref_dcn.parse_dcn_address(a)


def test_local_topology_keys_and_device_rule():
    topo = dcn.local_topology("cpu")
    ref = ref_dcn.local_topology()
    assert set(topo) == set(ref)
    assert topo["magic"] == ref["magic"] == dcn.DCN_MAGIC
    assert topo["platform"] == "cpu"
    assert topo["devices"] == [{"id": 0, "kind": "cpu"}]
    assert topo["nonce"] == dcn._PROCESS_NONCE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dcn.local_topology()              # cuda by default, no card here


def test_port_channel_handshakes_reference_server(ref_server):
    _, addr = ref_server
    ch = dcn.DcnChannel(f"ici://{addr}/0", device="cpu")
    topo = ch.handshake()
    assert topo["magic"] == "DCN1" and topo["platform"] == "cpu"
    assert ch.remote_device_ids() == list(range(8))   # the 8-device mesh
    assert ch.handshake() is topo                     # idempotent


def test_reference_channel_handshakes_port_server(port_server):
    _, addr = port_server
    topo = ref_dcn.DcnChannel(f"ici://{addr}/0").handshake()
    assert topo["magic"] == "DCN1" and topo["platform"] == "cpu"
    assert topo["devices"] == [{"id": 0, "kind": "cpu"}]
    assert topo["xfer"] is None            # no fabric: host-serialized
    assert topo["nonce"] == dcn._PROCESS_NONCE


def test_bad_magic_rejected(port_server):
    _, addr = port_server
    ch = rpc.Channel(addr, timeout_ms=10_000)
    with pytest.raises(errors.RpcError) as ei:
        ch.call_sync(dcn.DCN_SERVICE, "Hello", {"magic": "nope"},
                     serializer="json", response_serializer="json")
    assert ei.value.code == errors.EREQUEST


def test_device_calls_answer_enomethod_naming_item_8(port_server):
    _, addr = port_server
    ch = rpc.Channel(addr, timeout_ms=10_000)
    body = dcn._pack_envelope({"svc": "S", "method": "M", "chip": 0},
                              [np.ones(2, np.float32)])
    with pytest.raises(errors.RpcError, match="item 8") as ei:
        ch.call_sync(dcn.DCN_SERVICE, "CallDevice", body,
                     serializer="raw", response_serializer="raw")
    assert ei.value.code == errors.ENOMETHOD
    with pytest.raises(errors.RpcError, match="item 8") as ei:
        dcn.DcnChannel(addr, device="cpu").call_sync(
            "S", "M", np.ones(2, np.float32))
    assert ei.value.code == errors.ENOMETHOD
    # a reference client gets the same definite error over the wire
    with pytest.raises(Exception, match="item 8"):
        ref_dcn.DcnChannel(f"ici://{addr}/0").call_sync(
            "S", "M", np.ones(2, np.float32))


def test_server_without_enable_dcn_has_no_dcn_service():
    srv = rpc.Server()
    srv.start("127.0.0.1", 0)
    try:
        assert dcn.DCN_SERVICE not in srv.services
        with pytest.raises(errors.RpcError):
            dcn.DcnChannel(f"127.0.0.1:{srv.port}", timeout_ms=5000,
                           device="cpu").handshake()
    finally:
        srv.stop()
        srv.join()


def test_offer_table_release_and_ttl_sweep(monkeypatch):
    import torch
    base = dcn.live_offer_count()
    t1, specs = dcn.offer([torch.zeros(2, 3, dtype=torch.uint8),
                           torch.ones(4)])
    assert specs == [{"shape": [2, 3], "dtype": "uint8"},
                     {"shape": [4], "dtype": "float32"}]
    t2, _ = dcn.offer([torch.zeros(1)])
    assert t2 != t1 and dcn.live_offer_count() == base + 2
    dcn.release_offer(t1)
    dcn.release_offer(t1)                 # the ack is idempotent
    assert dcn.live_offer_count() == base + 1
    # the sweeper's purge drops an offer past its TTL
    with dcn._offers_mu:
        dcn._purge_offers_locked(dcn._offers[t2][1] + 1.0)
    assert dcn.live_offer_count() == base
    assert dcn.transfer_server() is None and dcn.transfer_address() is None
