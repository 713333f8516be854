"""Health checking (a copy of ``brpc_tpu/policy/health_check.py``).

When a connection to an endpoint fails, the endpoint is marked broken
and a probe thread reconnects every ``health_check_interval_s``; on
success the mark clears, the circuit breaker starts its re-admission
ramp, and load balancers select the endpoint again (they consult
:func:`is_broken`).  A mark may carry the breaker's isolation hold: the
probe does not revive the endpoint before it elapses.

The tables are the port's own: a verdict here never reaches the JAX
package's health check, nor the reverse.
"""
from __future__ import annotations

import socket as _socket
import threading
import time

from ..bvar import Adder
from ..butil.endpoint import EndPoint

health_check_interval_s = 1.0

_broken: dict[EndPoint, float] = {}     # endpoint -> since (monotonic)
_hold_until: dict[EndPoint, float] = {}  # breaker isolation hold deadline
# bumped by reset_all(); probe loops of an older generation exit instead
# of reviving endpoints into state that was deliberately cleared
_generation = 0
_mu = threading.Lock()
_probe_threads: dict[EndPoint, threading.Thread] = {}
_revived_counter = Adder("rpc_health_check_revived")
_broken_counter = Adder("rpc_health_check_broken")


def is_broken(ep: EndPoint) -> bool:
    with _mu:
        return ep in _broken


def broken_endpoints() -> list[EndPoint]:
    with _mu:
        return list(_broken)


def probe_threads() -> list[threading.Thread]:
    """The live probe threads (tests wait them out after ``reset_all``)."""
    with _mu:
        return list(_probe_threads.values())


def mark_broken(ep: EndPoint, hold_s: float = 0.0) -> None:
    """Mark ``ep`` broken and start its probe loop.  ``hold_s`` is the
    circuit breaker's isolation: the probe will not revive the endpoint
    before it elapses, even if the server is reachable."""
    if ep.scheme != "tcp":
        return
    with _mu:
        if hold_s > 0.0:
            _hold_until[ep] = max(_hold_until.get(ep, 0.0),
                                  time.monotonic() + hold_s)
        if ep in _broken:
            return
        _broken[ep] = time.monotonic()
        _broken_counter.add(1)
        t = threading.Thread(target=_probe_loop, args=(ep, _generation),
                             daemon=True, name=f"health-check-{ep}")
        _probe_threads[ep] = t
        t.start()


def on_connection_failed(ep: EndPoint) -> None:
    mark_broken(ep)
    from .circuit_breaker import global_breaker
    global_breaker().on_socket_failed(ep)


def _probe_loop(ep: EndPoint, gen: int) -> None:
    while True:
        time.sleep(health_check_interval_s)
        with _mu:
            if gen != _generation:
                _probe_threads.pop(ep, None)
                return              # state was reset under us: stand down
            hold = _hold_until.get(ep, 0.0)
        if time.monotonic() < hold:
            continue   # still inside the breaker's isolation hold
        try:
            with _socket.create_connection((ep.host, ep.port), timeout=1.0):
                pass
            break  # connectable again
        except OSError:
            continue
    with _mu:
        if gen != _generation:
            _probe_threads.pop(ep, None)
            return
        _broken.pop(ep, None)
        _hold_until.pop(ep, None)
        _probe_threads.pop(ep, None)
    _revived_counter.add(1)
    from .circuit_breaker import global_breaker
    global_breaker().on_revived(ep)   # start the gradual re-admission ramp


def reset(ep: EndPoint) -> None:
    """Force-clear one endpoint (tests, manual revive)."""
    with _mu:
        _broken.pop(ep, None)
        _hold_until.pop(ep, None)


def reset_all() -> None:
    """Clear every endpoint's state and retire the probe loops in flight
    (the generation bump makes them exit instead of reviving endpoints
    into the cleared state)."""
    global _generation
    with _mu:
        _generation += 1
        _broken.clear()
        _hold_until.clear()
