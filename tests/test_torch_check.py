"""brpc-check's passes over the port: 0 findings each.

``brpc_tpu/check`` scans the JAX package; the port is held to the same
passes here, through their constructor arguments and a ``Repo`` whose
``files()`` maps the package root ``brpc_tpu`` to ``brpc_tpu_torch``
(nothing in ``brpc_tpu/check`` is edited):

  * ``LockOrderPass`` and ``JitHotPathPass`` over ``brpc_tpu_torch``;
  * ``LockHygienePass`` over the port's serving, KV-cache and psserve
    modules: every lock there is a named ``InstrumentedLock``;
  * bounded-decode over the port's wire parsers (``rpc/tensorframe.py``,
    ``meta.py``, ``serialization.py``, ``stream.py``).

Each pass also runs on a copy holding one seeded violation, so a pass
that silently scans nothing cannot pass.
"""
import functools
import os
import shutil

import pytest

from brpc_tpu.check import bounded_decode
from brpc_tpu.check.base import Repo
from brpc_tpu.check.jit_hot_path import JitHotPathPass
from brpc_tpu.check.lock_hygiene import LockHygienePass
from brpc_tpu.check.lock_order import LockOrderPass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "brpc_tpu_torch"
PARSERS = tuple(f"{PORT}/rpc/{m}.py"
                for m in ("tensorframe", "meta", "serialization", "stream"))


class PortRepo(Repo):
    """A Repo whose package root is the port's."""

    def files(self, subdirs=("brpc_tpu",)):
        return super().files(tuple(PORT if s == "brpc_tpu" else s
                                   for s in subdirs))


def _passes(monkeypatch):
    monkeypatch.setattr(bounded_decode, "PARSER_MODULES", PARSERS)
    return {
        "lock-order": LockOrderPass(subdirs=(PORT,)),
        "jit-hot-path": JitHotPathPass(subdirs=(PORT,)),
        "lock-hygiene": LockHygienePass(prefixes=(f"{PORT}/serving/",
                                                  f"{PORT}/kvcache/",
                                                  f"{PORT}/psserve/")),
        "bounded-decode": bounded_decode.BoundedDecodePass(
            modules=bounded_decode.PARSER_MODULES),
    }


# one violation per pass, written into a copy of the port
SEEDED = {
    "lock-order": ("serving/_seeded.py", '''
from ..butil.lockprof import InstrumentedLock


class Seeded:
    def __init__(self):
        self._a = InstrumentedLock("seeded.a")
        self._b = InstrumentedLock("seeded.b")

    def ab(self):
        with self._a:
            with self._b:
                pass

    def ba(self):
        with self._b:
            with self._a:
                pass
'''),
    "jit-hot-path": ("serving/_seeded.py", '''
import jax


def per_call(x):
    return jax.jit(lambda y: y + 1)(x)
'''),
    "lock-hygiene": ("kvcache/_seeded.py", '''
import threading

_mu = threading.Lock()
'''),
    "bounded-decode": ("rpc/stream.py", '''

def _seeded(buf):
    import struct
    (n,) = struct.unpack_from("<I", buf, 0)
    return buf[4:4 + n]
'''),
}


@functools.cache
def _port_repo() -> PortRepo:
    """One Repo over the port for every pass: it parses each file once
    (the passes only read the parsed sources)."""
    return PortRepo(ROOT)


@pytest.mark.parametrize("pass_id", sorted(SEEDED))
def test_port_has_no_findings(pass_id, monkeypatch):
    p = _passes(monkeypatch)[pass_id]
    repo = _port_repo()
    assert repo.files(("brpc_tpu",)), "the port's files were not found"
    found = p.run(repo)
    assert found == [], "\n".join(map(str, found))


@pytest.mark.parametrize("pass_id", sorted(SEEDED))
def test_each_pass_sees_the_port(pass_id, monkeypatch, tmp_path):
    """The same pass over a copy of the port with one seeded violation
    reports it."""
    shutil.copytree(os.path.join(ROOT, PORT), tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu"))
    rel, src = SEEDED[pass_id]
    target = tmp_path / PORT / rel
    mode = "a" if target.exists() else "w"
    with open(target, mode) as f:
        f.write(src)
    found = _passes(monkeypatch)[pass_id].run(PortRepo(str(tmp_path)))
    assert [f.path for f in found] == [f"{PORT}/{rel}"], found
