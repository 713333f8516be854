"""DCN: the cross-process handshake and the envelope the migration plane
rides.

Port of ``brpc_tpu/ici/dcn.py``, the part that is not device RPC.  The
reference follows RdmaEndpoint's TCP-assisted handshake: the ``_dcn``
service's ``Hello`` exchanges device topology and this process's
transfer-fabric address over the ordinary TRPC connection, after which
payloads may move out of band.  Addressing is ``ici://host:port/chip``.

  * ``Hello`` answers :func:`local_topology` (the reference's keys:
    magic, pid, nonce, platform, devices) plus ``"xfer"``, so a
    reference peer's handshake accepts it and the reverse.
  * :func:`_pack_envelope` / :func:`_unpack_envelope`: json header plus
    ``TensorSerializer`` arrays, bounded trust (never pickle), byte for
    byte the reference's.
  * The offer table (:func:`offer`, :func:`release_offer`,
    :func:`live_offer_count`, the TTL sweeper) pins tensors offered to a
    peer until it acknowledges them.  Only a transfer fabric offers, so
    until the port has one nothing on its paths fills the table and
    ``live_offer_count()`` stays 0 (a check of it holds vacuously).

NO TRANSFER FABRIC.  The port does not start one: :func:`transfer_server`
and :func:`transfer_address` return None, ``Hello`` advertises
``"xfer": null`` -- the reference's own "no fabric" state -- and every
payload moves host-serialized on the envelope, on both sides of any
pair (the migrator's ``fallback`` counter counts each migration).  A
same-host CUDA IPC or NCCL fabric is ROADMAP Queue 1 item 5's remainder.

``DcnService.CallDevice`` and ``DcnChannel.call_sync`` need the device
service registry and the mesh (ROADMAP Queue 1 item 8): until then they
answer a definite ENOMETHOD naming it, on the wire and locally.
"""
from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
import uuid
from typing import Any, Optional

import torch

from .. import errors
from ..bvar import Adder
from ..device import resolve_device
from ..rpc.serialization import TensorSerializer
from ..rpc.service import Service, method

DCN_SERVICE = "_dcn"
DCN_MAGIC = "DCN1"          # handshake version tag (the "RDMA" preamble)

# process identity for the same-process check: pids collide across
# hosts and containers, a random nonce does not
_PROCESS_NONCE = uuid.uuid4().hex[:16]

_MAX_HEADER = 64 * 1024     # envelope header bound (bounded trust)

dcn_zero_copy_calls = Adder("dcn_zero_copy_calls")
dcn_fallback_calls = Adder("dcn_fallback_calls")

_NO_DEVICE_RPC = ("remote device services need the device-service "
                  "registry and the mesh (ROADMAP Queue 1 item 8), which "
                  "the port does not have yet")


def transfer_server():
    """This process's transfer fabric: None, always (see the module
    docstring); callers take the host-serialized path."""
    return None


def transfer_address() -> Optional[str]:
    return None


# ---- the offer table: tensors pinned for a peer until it acks them ----

# tickets must be unique across processes sharing a fabric: salt with pid
_ticket_counter = itertools.count((os.getpid() & 0xFFFF) << 32)
_OFFER_TTL_S = 120.0
_offers_mu = threading.Lock()
_offers: dict[int, tuple[list, float]] = {}
_sweeper_started = False


def _purge_offers_locked(now: float) -> None:
    dead = [t for t, (_, dl) in _offers.items() if dl < now]
    for t in dead:
        del _offers[t]


def _ensure_sweeper() -> None:
    # offered-but-never-acked tensors must not stay pinned past the TTL
    # just because no further offer() runs
    global _sweeper_started
    with _offers_mu:
        if _sweeper_started:
            return
        _sweeper_started = True

    def _loop():
        while True:
            time.sleep(_OFFER_TTL_S / 4)
            with _offers_mu:
                _purge_offers_locked(time.monotonic())

    threading.Thread(target=_loop, daemon=True,
                     name="dcn-offer-sweeper").start()


def _spec(t) -> dict:
    dt = str(t.dtype).replace("torch.", "")
    return {"shape": list(t.shape), "dtype": dt}


def offer(tensors: list) -> tuple[int, list[dict]]:
    """Pin `tensors` for a peer's pull under a fresh ticket.  Returns
    ``(ticket, specs)``, specs giving each tensor's shape and dtype.
    :func:`release_offer` (the ack) unpins; the sweeper drops offers
    older than the TTL."""
    ticket = next(_ticket_counter)
    with _offers_mu:
        _offers[ticket] = (list(tensors),
                           time.monotonic() + _OFFER_TTL_S)
    _ensure_sweeper()
    return ticket, [_spec(t) for t in tensors]


def release_offer(ticket: int) -> None:
    with _offers_mu:
        _offers.pop(ticket, None)


def live_offer_count() -> int:
    """Offers still pinned (not yet acked or swept): a burst of
    migrations must leave it at 0."""
    with _offers_mu:
        return len(_offers)


# ---- the envelope ----

def _pack_envelope(header: dict, arrays: list) -> bytes:
    """json header + tensor-serialized arrays: u32 header_len, header
    json, u32 tensor_header_len, tensor header, tensor bodies.  The
    arrays (numpy, or anything ``np.asarray`` takes) ride the
    TensorSerializer, so nothing here interprets network bytes as
    code."""
    hdr = json.dumps(header).encode()
    if not arrays:
        # control-only envelope: no serializer touch
        return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", 0)
    tbody, theader = TensorSerializer().encode(arrays)
    return (struct.pack("<I", len(hdr)) + hdr +
            struct.pack("<I", len(theader)) + theader + tbody)


def _unpack_envelope(data: bytes) -> tuple[dict, list]:
    if len(data) < 8:
        raise ValueError("envelope too short")
    (hlen,) = struct.unpack_from("<I", data, 0)
    if hlen > _MAX_HEADER or 4 + hlen + 4 > len(data):
        raise ValueError("bad envelope header length")
    header = json.loads(data[4:4 + hlen].decode())
    (tlen,) = struct.unpack_from("<I", data, 4 + hlen)
    off = 8 + hlen
    if off + tlen > len(data):
        raise ValueError("bad tensor header length")
    if tlen == 0:
        return header, []           # control-only
    theader = data[off:off + tlen]
    arrays = TensorSerializer().decode(data[off + tlen:], theader)
    if not isinstance(arrays, (list, tuple)):
        arrays = [arrays]
    return header, list(arrays)


def local_topology(device=None) -> dict:
    """This process's device inventory, the handshake payload: every
    CUDA card (``platform`` "gpu", each card's name as ``kind``) unless
    ``device`` is the CPU (``platform`` "cpu", one device).  ``device``
    defaults to ``cuda`` and raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        platform = "gpu"
        devs = [{"id": i, "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())]
    else:
        platform = dev.type
        devs = [{"id": 0, "kind": dev.type}]
    return {"magic": DCN_MAGIC, "pid": os.getpid(),
            "nonce": _PROCESS_NONCE, "platform": platform,
            "devices": devs}


class DcnService(Service):
    """Server half: the topology exchange.  Registered by
    ``Server(enable_dcn=True)``; ``device`` is what ``Hello`` reports
    (``ServerOptions.dcn_device``, default ``cuda``)."""

    NAME = DCN_SERVICE

    def __init__(self, device=None):
        self._device = device

    @method(request="json", response="json")
    def Hello(self, cntl, req):
        peer = req if isinstance(req, dict) else {}
        if peer.get("magic") != DCN_MAGIC:
            cntl.set_failed(errors.EREQUEST, "bad DCN handshake magic")
            return None
        topo = local_topology(self._device)
        topo["xfer"] = transfer_address()
        return topo

    @method(request="raw", response="raw")
    def CallDevice(self, cntl, req):
        cntl.set_failed(errors.ENOMETHOD, _NO_DEVICE_RPC)
        return None


def parse_dcn_address(address: str) -> tuple[str, int, Optional[int]]:
    """``ici://host:port/chip`` | ``ici://host:port`` | ``host:port``
    -> (host, port, chip|None)."""
    s = address
    if s.startswith("ici://"):
        s = s[len("ici://"):]
    chip: Optional[int] = None
    if "/" in s:
        s, chip_s = s.split("/", 1)
        chip = int(chip_s)
    host, port_s = s.rsplit(":", 1)
    return host, int(port_s), chip


class DcnChannel:
    """Client half: ``DcnChannel("ici://hostB:8000/3")`` handshakes with
    hostB's RPC server; services that ride beside the DCN data plane
    (the ``_kvmig`` page stream, the disagg pairing RPCs) issue their
    control calls over :attr:`channel`, the connection the handshake
    used.  ``device`` is what this side's ``Hello`` reports (default
    ``cuda``)."""

    def __init__(self, address: str, timeout_ms: int = 10_000,
                 default_chip: Optional[int] = None, device=None):
        from ..rpc.channel import Channel
        host, port, chip = parse_dcn_address(address)
        self.remote = f"{host}:{port}"
        self.default_chip = chip if chip is not None else default_chip
        self.device = device
        self._ch = Channel(self.remote, timeout_ms=timeout_ms)
        self.topology: Optional[dict] = None

    @property
    def channel(self):
        """The control-plane RPC channel under this DCN channel."""
        return self._ch

    def handshake(self) -> dict:
        """Exchange topologies (idempotent); returns the remote's."""
        if self.topology is None:
            self.topology = self._ch.call_sync(
                DCN_SERVICE, "Hello", local_topology(self.device),
                serializer="json", response_serializer="json")
        return self.topology

    def remote_device_ids(self) -> list[int]:
        return [d["id"] for d in self.handshake()["devices"]]

    def call_sync(self, service: str, method_name: str, request: Any,
                  chip: Optional[int] = None):
        raise errors.RpcError(errors.ENOMETHOD, _NO_DEVICE_RPC)
