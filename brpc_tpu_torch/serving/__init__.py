"""Serving: the continuous-batching decode engine, its draft proposers
for speculative decoding, the dynamic batcher, the engine supervisor,
and the ``Serving`` RPC service in front of them.

Every live batcher, engine and supervisor registers here, weakly and by
name (as in ``brpc_tpu/serving/__init__.py``), so a console can list
them without keeping a closed component alive.
"""
from __future__ import annotations

import threading
import weakref

_reg_mu = threading.Lock()
_batchers: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_engines: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_supervisors: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def _register_batcher(b) -> None:
    with _reg_mu:
        _batchers[b.name] = b


def _register_engine(e) -> None:
    with _reg_mu:
        _engines[e.name] = e


def _register_supervisor(s) -> None:
    with _reg_mu:
        _supervisors[s.name] = s


from .batcher import DynamicBatcher  # noqa: E402,F401
from .engine import DecodeEngine  # noqa: E402,F401
from .service import (ScoreClient, ServingService,  # noqa: E402,F401
                      register_serving)
from .speculative import (DraftModelProposer, DraftProposer,  # noqa: E402,F401
                          NGramProposer, as_proposer)
from .supervisor import EngineSupervisor  # noqa: E402,F401
