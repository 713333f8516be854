"""The SLO burn-rate engine: the evaluator that closes the canary loop
(a copy of ``brpc_tpu/serving/slo.py``).

Declarative objectives per deployment key -- TTFT p99, ITL p99, error
rate -- are evaluated as multi-window burn rates over the fleet series
the :class:`~brpc_tpu_torch.serving.telemetry.FleetCollector` keeps: an
objective is BURNING only when its burn (observed / target) exceeds the
threshold over BOTH a short window (fast detection) and a long window
(sustained, not a blip).

The engine's verdicts drive three outputs:

  * CANARY RAMP.  A canary (the router's smooth-WRR split) is PROMOTED
    to 100/0 after N consecutive clean windows: the engine re-weights
    the canary warm and drains the baseline through the router's
    epoch-fenced ``deploy_model`` push, so a superseded router's
    promotion is refused like any stale floor push.  It is ROLLED BACK
    the moment the canary burns while the baseline does not (or burns
    ``rollback_margin`` times faster): baseline re-weighted warm, canary
    drained.  Both ends are terminal -- one decision per engine, with
    the trail kept for ``/fleet``.
  * DISRUPTION HOLD.  While the collector reports a tombstoned (or
    recently tombstoned or recovered) replica, every canary decision is
    held: burn caused by a killed replica must neither promote nor roll
    back.  The clean-window streak freezes and resumes when the fleet
    settles.
  * ADVISORY FLOOR.  :meth:`SLOEngine.floor` is 1 while any objective
    burns; registered as a floor source on the router's overload ladder
    it holds the gradient at level >= 1 (shed at the router) and never
    higher: SLO pressure advises, the pressure gradient escalates.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..butil.lockprof import InstrumentedLock

# verdicts
OK = "OK"
BURNING = "BURNING"
INSUFFICIENT = "INSUFFICIENT_DATA"
HOLD = "HOLD"

# terminal ramp states
RAMPING = "ramping"
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"

# metrics an Objective may target (all read from the router-sampled
# fleet series, replica="router")
METRIC_TTFT = "ttft_p99_ms"
METRIC_ITL = "itl_p99_ms"
METRIC_ERROR_RATE = "error_rate"


@dataclass(frozen=True)
class Objective:
    """One declarative objective: ``metric`` must stay at or under
    ``target`` (milliseconds for the latency metrics, a ratio for
    ``error_rate``).  Burn = observed / target."""
    metric: str
    target: float

    def __post_init__(self):
        if self.metric not in (METRIC_TTFT, METRIC_ITL,
                               METRIC_ERROR_RATE):
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if not self.target > 0:
            raise ValueError("SLO target must be positive")


def _burn(collector, model: str, metric: str, target: float,
          window_s: float, now: float) -> Optional[float]:
    """Burn rate of one (model, metric) over one trailing window, or
    None when the window holds too little data to judge."""
    if metric == METRIC_ERROR_RATE:
        fin = collector.window_values("router", model, "finished",
                                      window_s, now)
        fail = collector.window_values("router", model, "failed",
                                       window_s, now)
        if len(fin) < 2 or len(fail) < 2:
            return None
        d_fin = max(0.0, fin[-1] - fin[0])
        d_fail = max(0.0, fail[-1] - fail[0])
        total = d_fin + d_fail
        if total <= 0:
            return None   # no finishes this window: nothing to judge
        return (d_fail / total) / target
    vals = collector.window_values("router", model, metric, window_s, now)
    if len(vals) < 2:
        return None
    return (sum(vals) / len(vals)) / target


class SLOEngine:
    """Burn-rate evaluator + canary controller for ONE model_id's
    baseline/canary version pair (see module docstring).  Drive it
    from the router tick: :meth:`tick` evaluates, decides, and (at
    most once) pushes the promote/rollback through the router."""

    def __init__(self, model_id: str, baseline: str, canary: str,
                 objectives, *,
                 short_window_s: float = 2.0,
                 long_window_s: float = 6.0,
                 burn_threshold: float = 1.0,
                 rollback_margin: float = 1.5,
                 clean_windows: int = 3,
                 hold_window_s: Optional[float] = None,
                 trail_keep: int = 64,
                 act: bool = True):
        self.model_id = str(model_id)
        self.baseline = str(baseline)
        self.canary = str(canary)
        self.objectives = [o if isinstance(o, Objective)
                           else Objective(**o) for o in objectives]
        if not self.objectives:
            raise ValueError("SLOEngine needs at least one objective")
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self.rollback_margin = float(rollback_margin)
        self.clean_windows = max(1, int(clean_windows))
        self.hold_window_s = float(hold_window_s
                                   if hold_window_s is not None
                                   else long_window_s)
        # act=False is OBSERVE-ONLY: burns, verdicts, trail and the
        # advisory floor all run, but the engine never promotes or
        # rolls back (rpc_press --slo over a fleet with no real
        # baseline/canary pair to re-weight)
        self.act = bool(act)
        self._mu = InstrumentedLock("slo.engine")
        self.state = RAMPING
        self.clean_streak = 0
        self._last_window_t: Optional[float] = None
        self._last_verdict: Optional[str] = None
        self._burning_now = False
        self.evaluations = 0
        self.holds = 0
        self._trail: deque = deque(maxlen=max(8, int(trail_keep)))
        self._last_eval: dict = {}

    # ---- evaluation ---------------------------------------------------

    def _evaluate_key(self, collector, key: str,
                      now: float) -> tuple[str, dict]:
        """Verdict + per-objective burns for one deployment key:
        BURNING iff ANY objective burns over BOTH windows; OK iff every
        objective has data and none burns; INSUFFICIENT otherwise."""
        burns: dict[str, dict] = {}
        any_burning = False
        any_data = False
        all_data = True
        for o in self.objectives:
            bs = _burn(collector, key, o.metric, o.target,
                       self.short_window_s, now)
            bl = _burn(collector, key, o.metric, o.target,
                       self.long_window_s, now)
            burns[o.metric] = {
                "target": o.target,
                "short": round(bs, 3) if bs is not None else None,
                "long": round(bl, 3) if bl is not None else None,
            }
            if bs is None or bl is None:
                all_data = False
                continue
            any_data = True
            if bs > self.burn_threshold and bl > self.burn_threshold:
                any_burning = True
                burns[o.metric]["burning"] = True
        if any_burning:
            return BURNING, burns
        if not any_data or not all_data:
            return INSUFFICIENT, burns
        return OK, burns

    def _note(self, now: float, verdict: str, detail: str,
              action: Optional[str] = None) -> None:
        """Append to the decision trail on verdict changes and actions
        (a trail of every evaluation would bury the story ``/fleet``
        tells)."""
        if action is None and verdict == self._last_verdict:
            return
        self._last_verdict = verdict
        self._trail.append({
            "t": round(time.time(), 3),
            "verdict": verdict,
            "state": self.state,
            "clean_windows": self.clean_streak,
            "detail": detail,
            **({"action": action} if action else {}),
        })

    # ---- the control loop ---------------------------------------------

    def tick(self, collector, router=None,
             now: Optional[float] = None) -> str:
        """One evaluation pass: returns the verdict and (at most once,
        ever) pushes a promote/rollback through ``router``.  Safe to
        call from the router's tick thread at any cadence — windows are
        measured in time, not ticks."""
        now = time.monotonic() if now is None else now
        with self._mu:
            self.evaluations += 1
            can_v, can_b = self._evaluate_key(collector, self.canary, now)
            base_v, base_b = self._evaluate_key(collector, self.baseline,
                                                now)
            # the advisory floor follows only deployments still taking
            # traffic: after a terminal decision the LOSER is drained,
            # and its frozen percentile reservoir (ModelMetrics is
            # cumulative) would otherwise read BURNING forever and pin
            # the fleet at shed-at-router
            if self.state == ROLLED_BACK:
                self._burning_now = base_v == BURNING
            elif self.state == PROMOTED:
                self._burning_now = can_v == BURNING
            else:
                self._burning_now = BURNING in (can_v, base_v)
            self._last_eval = {
                "t": round(time.time(), 3),
                "canary": {"verdict": can_v, "burns": can_b},
                "baseline": {"verdict": base_v, "burns": base_b},
            }
            if not self.act:
                self._note(now, can_v, "observe-only evaluation")
                return can_v
            if self.state != RAMPING:
                return self.state
            if collector.disruption_within(self.hold_window_s, now):
                self.holds += 1
                self._note(now, HOLD,
                           f"disruption window active "
                           f"(tombstoned={collector.tombstoned()}): "
                           f"canary ramp frozen")
                return HOLD
            if can_v == BURNING:
                worse = self._canary_burns_faster(can_b, base_b)
                if base_v != BURNING or worse:
                    self.state = ROLLED_BACK
                    self.clean_streak = 0
                    self._note(now, BURNING,
                               f"canary {self.canary} burning "
                               f"(baseline {base_v}): rolling back "
                               f"to {self.baseline} 100/0",
                               action="rollback")
                    if router is not None:
                        self._push(router, keep=self.baseline,
                                   drain=self.canary)
                    return BURNING
                # the whole fleet burns: not the canary's fault — hold
                # the ramp, let the advisory floor do its job
                self.clean_streak = 0
                self._note(now, BURNING,
                           "baseline burning too: fleet-wide pressure, "
                           "no canary verdict")
                return BURNING
            if can_v == OK:
                if (self._last_window_t is None
                        or now - self._last_window_t
                        >= self.short_window_s):
                    self._last_window_t = now
                    self.clean_streak += 1
                    self._note(now, OK,
                               f"clean window {self.clean_streak}/"
                               f"{self.clean_windows} for {self.canary}",
                               action="clean_window")
                if self.clean_streak >= self.clean_windows:
                    self.state = PROMOTED
                    self._note(now, OK,
                               f"{self.clean_streak} clean windows: "
                               f"promoting {self.canary} to 100/0",
                               action="promote")
                    if router is not None:
                        self._push(router, keep=self.canary,
                                   drain=self.baseline)
                return OK
            self._note(now, INSUFFICIENT,
                       f"not enough windowed data for {self.canary}")
            return INSUFFICIENT

    def _canary_burns_faster(self, can_b: dict, base_b: dict) -> bool:
        for metric, cb in can_b.items():
            bl = cb.get("long")
            if bl is None:
                continue
            ob = (base_b.get(metric) or {}).get("long")
            if ob is None or bl > ob * self.rollback_margin:
                return True
        return False

    @staticmethod
    def _push(router, *, keep: str, drain: str) -> None:
        """The ramp mutation: winner re-deployed warm at weight 1,
        loser drained — the smooth-WRR split then routes 100/0 because
        ``version_weights`` excludes DRAINING keys.  Rides the
        epoch-fenced ``deploy_model`` push; partial failure is re-tried
        by the next deploy, never by re-deciding."""
        router.deploy_model(keep, op="deploy", weight=1, state="warm")
        router.deploy_model(drain, op="drain")

    # ---- outputs ------------------------------------------------------

    def floor(self) -> int:
        """Advisory overload-ladder floor: 1 while any objective burns
        (shed at the router), 0 otherwise.  Never higher — SLO pressure
        advises, the pressure gradient escalates."""
        with self._mu:
            return 1 if self._burning_now else 0

    def trail(self) -> list[dict]:
        with self._mu:
            return list(self._trail)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "model_id": self.model_id,
                "baseline": self.baseline,
                "canary": self.canary,
                "state": self.state,
                "objectives": [{"metric": o.metric, "target": o.target}
                               for o in self.objectives],
                "windows_s": {"short": self.short_window_s,
                              "long": self.long_window_s,
                              "hold": self.hold_window_s},
                "burn_threshold": self.burn_threshold,
                "clean_windows": {"streak": self.clean_streak,
                                  "required": self.clean_windows},
                "evaluations": self.evaluations,
                "holds": self.holds,
                "floor": 1 if self._burning_now else 0,
                "last_eval": dict(self._last_eval),
                "trail": list(self._trail),
            }


__all__ = [
    "OK", "BURNING", "INSUFFICIENT", "HOLD",
    "RAMPING", "PROMOTED", "ROLLED_BACK",
    "METRIC_TTFT", "METRIC_ITL", "METRIC_ERROR_RATE",
    "Objective", "SLOEngine",
]
