"""Fault tolerance primitives for the training fleet (the port's copy of
``repro.dist.fault``: the standard library only).

Two concerns (DESIGN.md deployment story):

  * restarts — a step failure triggers restore-from-checkpoint; only the
    LoRA adapters + optimizer moments move (megabytes), so the restart
    budget is generous.
  * stragglers — a step that runs far slower than the EMA is first observed
    (could be a transient), then — after ``straggler_patience`` consecutive
    slow steps — the coordinator requests a spare swap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class RestartPolicy:
    max_restarts: int = 3            # give up after this many step failures
    straggler_factor: float = 3.0    # dt > factor * EMA counts as straggling
    straggler_patience: int = 3      # consecutive slow steps before swapping
    ema_decay: float = 0.9


class FaultCoordinator:
    """Tracks step health; decides observe / swap_spare / restart actions."""

    def __init__(self, policy: Optional[RestartPolicy] = None):
        self.policy = policy or RestartPolicy()
        self.restarts = 0
        self.decisions: List[Dict] = []
        self._ema: Optional[float] = None
        self._slow_streak = 0

    def on_step(self, step: int, dt: float) -> Optional[str]:
        """Feed one step duration; returns an action string when the step
        looks like a straggler, else None. The EMA only absorbs healthy
        steps so a long straggler run cannot normalize itself."""
        p = self.policy
        if self._ema is None:
            self._ema = dt
            return None
        if dt > p.straggler_factor * self._ema:
            self._slow_streak += 1
            action = ("swap_spare" if self._slow_streak >= p.straggler_patience
                      else "observe")
            self.decisions.append({"step": step, "action": action,
                                   "dt": dt, "ema": self._ema})
            if action == "swap_spare":
                self._slow_streak = 0
            return action
        self._slow_streak = 0
        self._ema = p.ema_decay * self._ema + (1 - p.ema_decay) * dt
        return None

    def should_restart(self, exc: BaseException) -> bool:
        """Account one step failure; True while the restart budget lasts."""
        self.restarts += 1
        self.decisions.append({"action": "restart", "n": self.restarts,
                               "exc": type(exc).__name__})
        return self.restarts <= self.policy.max_restarts
