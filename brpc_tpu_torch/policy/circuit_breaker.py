"""CircuitBreaker -- per-endpoint error and latency isolation (a copy of
``brpc_tpu/policy/circuit_breaker.py``).

Two EMA windows per endpoint (short: reacts in tens of calls; long:
hundreds), each tracking both the error rate and the latency:

- error isolation: short error EMA > 50% or long error EMA > 20%;
- latency isolation: the short latency EMA above LATENCY_RATIO x the
  long (baseline) latency EMA isolates the endpoint at a 0% error rate.

Isolation hands the endpoint to the health check with a hold that
doubles per consecutive isolation (100 ms up to 30 s), so a flapping
server stays out longer each time.  After revival the endpoint enters a
recovery ramp: balancers re-admit it with a probability that grows
linearly over RECOVERY_WINDOW_S.  A ClusterRecoverPolicy
(``cluster_recover_policy.py``) can veto an isolation that would leave
too few servers.  ``global_breaker()`` is the port's own: its evidence
never mixes with the JAX package's.
"""
from __future__ import annotations

import random
import threading
import time

from ..butil.endpoint import EndPoint


class _WindowState:
    __slots__ = ("ema_error", "ema_latency", "samples", "lat_samples")

    def __init__(self):
        self.ema_error = 0.0
        self.ema_latency = 0.0
        self.samples = 0
        self.lat_samples = 0

    def add_error(self, decay: float, err: float) -> None:
        self.ema_error = decay * self.ema_error + (1 - decay) * err
        self.samples += 1

    def add_latency(self, decay: float, latency_us: int) -> None:
        if self.ema_latency == 0.0:
            self.ema_latency = float(latency_us)
        else:
            self.ema_latency = decay * self.ema_latency + \
                (1 - decay) * latency_us
        self.lat_samples += 1


class CircuitBreaker:
    SHORT_DECAY = 0.7       # reacts in ~tens of calls
    LONG_DECAY = 0.98       # reacts in ~hundreds
    SHORT_THRESHOLD = 0.5   # >50% recent errors
    LONG_THRESHOLD = 0.2
    MIN_SAMPLES = 16
    # latency isolation: short EMA > RATIO x long (baseline) EMA, with a
    # floor so micro-latency jitter on sub-ms calls can't trip it
    LATENCY_RATIO = 4.0
    MIN_BASELINE_US = 200
    MIN_LATENCY_SAMPLES = 32      # long-window baseline maturity
    MIN_SHORT_LATENCY_SAMPLES = 8  # short window must have real evidence —
    # without this, the first slow success after a reset/revival seeds the
    # short EMA to its full value and instantly re-isolates on one sample
    # isolation hold: doubles per consecutive isolation (reference
    # min/max isolation_duration_ms)
    BASE_HOLD_S = 0.1
    MAX_HOLD_S = 30.0
    # gradual re-admission ramp after revival
    RECOVERY_WINDOW_S = 3.0

    def __init__(self):
        self._mu = threading.Lock()
        self._short: dict[EndPoint, _WindowState] = {}
        self._long: dict[EndPoint, _WindowState] = {}
        self._isolation_count: dict[EndPoint, int] = {}
        self._recovering_until: dict[EndPoint, float] = {}

    def on_call_end(self, ep: EndPoint, error_code: int,
                    latency_us: int = 0, cluster=None) -> None:
        """Feed one call result (reference OnCallEnd).  `cluster` is an
        optional ClusterRecoverPolicy-bound guard consulted before
        isolating."""
        err = 1.0 if error_code != 0 else 0.0
        isolate = False
        with self._mu:
            s = self._short.setdefault(ep, _WindowState())
            l = self._long.setdefault(ep, _WindowState())
            s.add_error(self.SHORT_DECAY, err)
            l.add_error(self.LONG_DECAY, err)
            # latency tracks successful calls only (a failed call's latency
            # is its timeout, which would poison the baseline)
            if err == 0.0 and latency_us > 0:
                s.add_latency(self.SHORT_DECAY, latency_us)
                # baseline-poisoning guard: once the long baseline is
                # mature, suspicious samples (>2x baseline) do NOT feed it.
                # Without this the degradation contaminates its own
                # yardstick — with both windows fed, s>4*l is only ever
                # reachable for slowdowns >~7.7x, and the documented 4-5x
                # degradation never isolates.  Freezing the baseline under
                # suspicion makes a sustained r-times slowdown trip once
                # s -> r*baseline > RATIO*baseline, i.e. any r > RATIO.
                if (l.lat_samples < self.MIN_LATENCY_SAMPLES
                        or l.ema_latency == 0.0
                        or latency_us <= 2 * l.ema_latency):
                    l.add_latency(self.LONG_DECAY, latency_us)
            if s.samples >= self.MIN_SAMPLES and (
                    s.ema_error > self.SHORT_THRESHOLD or
                    l.ema_error > self.LONG_THRESHOLD):
                isolate = True
            elif (l.lat_samples >= self.MIN_LATENCY_SAMPLES
                    and s.lat_samples >= self.MIN_SHORT_LATENCY_SAMPLES
                    and l.ema_latency > 0 and s.ema_latency >
                    self.LATENCY_RATIO * max(l.ema_latency,
                                             self.MIN_BASELINE_US)):
                # pure latency degradation: no errors required
                isolate = True
            if isolate:
                if cluster is not None and not cluster.can_isolate(ep):
                    # availability floor wins.  Reset the short window so
                    # evidence must re-accumulate (MIN_SAMPLES calls)
                    # before the next isolation attempt — otherwise every
                    # subsequent call re-trips this branch and re-walks
                    # the cluster guard's O(servers) scan while the
                    # cluster is already degraded
                    isolate = False
                    self._short[ep] = _WindowState()
                else:
                    self._short[ep] = _WindowState()
                    self._isolation_count[ep] = \
                        self._isolation_count.get(ep, 0) + 1
        if isolate:
            self.mark_as_broken(ep)

    def _hold_s(self, ep: EndPoint) -> float:
        # cap the exponent BEFORE exponentiating: a flapping endpoint can
        # accumulate thousands of isolations and 2**n overflows float
        # (OverflowError on the response thread under sustained timeouts)
        n = min(self._isolation_count.get(ep, 1), 32)
        return min(self.MAX_HOLD_S, self.BASE_HOLD_S * (2 ** (n - 1)))

    def mark_as_broken(self, ep: EndPoint) -> None:
        from .health_check import mark_broken
        with self._mu:
            hold = self._hold_s(ep)
        mark_broken(ep, hold_s=hold)

    def on_socket_failed(self, ep: EndPoint) -> None:
        with self._mu:
            self._isolation_count[ep] = self._isolation_count.get(ep, 0) + 1

    def on_revived(self, ep: EndPoint) -> None:
        """Health check succeeded: start the gradual re-admission ramp.
        BOTH windows reset — a retained long-window error EMA near 1.0
        would re-isolate a now-healthy endpoint after its first
        MIN_SAMPLES successes (0.98-decay needs ~80 successes to cross
        back under the 0.2 threshold)."""
        with self._mu:
            self._short.pop(ep, None)
            self._long.pop(ep, None)
            self._recovering_until[ep] = \
                time.monotonic() + self.RECOVERY_WINDOW_S

    def _ramp_done_locked(self, ep: EndPoint) -> None:
        del self._recovering_until[ep]
        # a survived ramp is one unit of forgiveness, not amnesty:
        # decrement so a slow flapper (up-time > ramp) still climbs
        # the exponential hold ladder across cycles
        n = self._isolation_count.get(ep, 0)
        if n <= 1:
            self._isolation_count.pop(ep, None)
        else:
            self._isolation_count[ep] = n - 1

    def admit(self, ep: EndPoint) -> bool:
        """Gradual recovery gate for load balancers: during the ramp a
        freshly-revived endpoint receives a linearly-growing fraction of
        selections instead of its full share at once."""
        if not self._recovering_until:
            return True   # GIL-atomic empty check: no lock on the hot path
        with self._mu:
            now = time.monotonic()
            # sweep ALL expired entries, not just ep's: an endpoint removed
            # from the cluster mid-ramp is never passed to admit() again,
            # and a leaked entry would disable the lock-free fast path
            # above for every selection in the process, forever
            for other in [e for e, u in self._recovering_until.items()
                          if now >= u]:
                self._ramp_done_locked(other)
            until = self._recovering_until.get(ep)
            if until is None:
                return True
            frac = 1.0 - (until - now) / self.RECOVERY_WINDOW_S
        return random.random() < max(0.1, frac)

    def reset(self, ep: EndPoint) -> None:
        with self._mu:
            self._short.pop(ep, None)
            self._long.pop(ep, None)
            self._recovering_until.pop(ep, None)

    def isolation_count(self, ep: EndPoint) -> int:
        with self._mu:
            return self._isolation_count.get(ep, 0)


_breaker = None
_breaker_mu = threading.Lock()


def global_breaker() -> CircuitBreaker:
    global _breaker
    with _breaker_mu:
        if _breaker is None:
            _breaker = CircuitBreaker()
        return _breaker
