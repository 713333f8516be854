"""OverloadLadder: the escalation/hysteresis policy of the supervisor's
degradation levels (a copy of ``brpc_tpu/serving/ladder.py``).

  * ESCALATION IS IMMEDIATE: the moment any pressure metric crosses a
    level's threshold, the ladder jumps straight to that level;
  * DE-ESCALATION IS HYSTERETIC: one level at a time, and only after
    ``hysteresis_ticks`` consecutive calm ticks, so a load oscillating
    around a threshold cannot flap the ladder.

Each level keeps a fire counter (``escalations[level]``) and the tick
it first fired at, so tests can prove the order in which levels fire.
"""
from __future__ import annotations

from typing import Mapping, Sequence


class OverloadLadder:
    """The escalate/hysteresis state machine over per-level pressure
    thresholds.  ``thresholds`` holds one dict per level 1..N; a level
    is *pressed* when ANY of its metrics meets or exceeds its bound.
    ``update(pressures)`` advances one tick; ``floor`` holds the ladder
    at a minimum level whatever the local pressures."""

    def __init__(self, thresholds: Sequence[Mapping[str, float]], *,
                 hysteresis_ticks: int = 5):
        self.thresholds = tuple(dict(t) for t in thresholds)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.level = 0
        self.floor = 0
        self._calm_ticks = 0
        # per level (index 0 unused): escalations that REACHED it, so a
        # ramp 0 -> 3 counts levels 1, 2 and 3
        self.escalations = [0] * (len(self.thresholds) + 1)
        self.de_escalations = 0
        self._tick = 0
        self.first_fired = [None] * (len(self.thresholds) + 1)

    @property
    def num_levels(self) -> int:
        return len(self.thresholds)

    def target_level(self, pressures: Mapping[str, float]) -> int:
        """The highest level with ANY metric at or above its bound (0
        when none is); metrics missing from ``pressures`` don't press."""
        lvl = 0
        for i, th in enumerate(self.thresholds, start=1):
            if any(k in pressures and pressures[k] >= th[k] for k in th):
                lvl = i
        return lvl

    def update(self, pressures: Mapping[str, float]) -> int:
        """One tick: escalate at once to the pressed level, de-escalate
        one level per ``hysteresis_ticks`` calm ticks, never below
        ``floor``."""
        self._tick += 1
        target = max(self.target_level(pressures), self.floor)
        if target > self.level:
            for lvl in range(self.level + 1, target + 1):
                self.escalations[lvl] += 1
                if self.first_fired[lvl] is None:
                    self.first_fired[lvl] = self._tick
            self.level = target
            self._calm_ticks = 0
        elif target < self.level:
            self._calm_ticks += 1
            if self._calm_ticks >= self.hysteresis_ticks:
                self.level -= 1
                self.de_escalations += 1
                self._calm_ticks = 0
        else:
            self._calm_ticks = 0
        return self.level

    def reset(self) -> None:
        self.level = 0
        self.floor = 0
        self._calm_ticks = 0

    def stats(self) -> dict:
        return {
            "level": self.level,
            "floor": self.floor,
            "num_levels": self.num_levels,
            "hysteresis_ticks": self.hysteresis_ticks,
            "calm_ticks": self._calm_ticks,
            "escalations": list(self.escalations[1:]),
            "first_fired": list(self.first_fired[1:]),
            "de_escalations": self.de_escalations,
        }


def apply_level_to_components(level: int, *, supervisor=None,
                              batcher=None, engine=None, store=None,
                              clamp_new_tokens: int = 32,
                              evict_pages=None) -> None:
    """Drive one replica's components to the cluster gradient `level`:
    a supervisor is held at a floor one below it (its three local
    levels sit under a router's shed level); otherwise level >= 2
    browns the batcher out, >= 3 clamps new generations' budgets, >= 4
    evicts cached pages."""
    if supervisor is not None:
        supervisor.set_level_floor(max(0, int(level) - 1))
        return
    if batcher is not None:
        batcher.brownout = max(batcher.brownout, 1) if level >= 2 else 0
    if engine is not None:
        engine.degraded_clamp = clamp_new_tokens if level >= 3 else None
    if level >= 4 and store is not None:
        n = evict_pages
        if n is None:
            try:
                n = store.pagepool.pages_per_block
            except Exception:
                n = 4
        try:
            store.evict_pages(n)
        except Exception:
            pass
