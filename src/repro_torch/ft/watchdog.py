"""Step-time watchdog: failure detection + straggler mitigation policy (a
copy of the JAX package's ``ft/watchdog.py``, pure Python).

At 1000+-node scale the two dominant incidents are (i) a host dying
mid-step (collective hangs) and (ii) a straggler stretching every step.
The monitor tracks a robust step-time estimate (the median over a
window); a step beyond ``hang_factor``x the median is treated as a hang
-> restart-from-checkpoint; persistent ``straggler_factor``x steps
trigger the straggler policy (at deployment: evict the slow host and
re-mesh; here the decision logic is what is exercised and tested).  Its
verdicts equal the JAX monitor's on the same durations.  Time a step
that runs on the card only after a ``torch.cuda.synchronize()``: the
host returns before the device finishes.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional


@dataclasses.dataclass
class StragglerPolicy:
    straggler_factor: float = 1.5
    hang_factor: float = 5.0
    window: int = 50
    min_samples: int = 5
    patience: int = 3      # consecutive slow steps before eviction


class StepMonitor:
    def __init__(self, policy: Optional[StragglerPolicy] = None):
        self.policy = policy or StragglerPolicy()
        self.durations: Deque[float] = collections.deque(
            maxlen=self.policy.window)
        self._slow_streak = 0
        self._t0: Optional[float] = None
        self.events = []

    # -- timing ------------------------------------------------------------
    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self) -> str:
        assert self._t0 is not None, "start_step not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    # -- decision ----------------------------------------------------------
    def observe(self, duration_s: float) -> str:
        """Feed one step duration; returns 'ok' | 'straggler' | 'hang'."""
        verdict = "ok"
        if len(self.durations) >= self.policy.min_samples:
            med = sorted(self.durations)[len(self.durations) // 2]
            if duration_s > self.policy.hang_factor * med:
                verdict = "hang"
                self.events.append(("hang", duration_s, med))
            elif duration_s > self.policy.straggler_factor * med:
                self._slow_streak += 1
                if self._slow_streak >= self.policy.patience:
                    verdict = "straggler"
                    self.events.append(("straggler", duration_s, med))
            else:
                self._slow_streak = 0
        self.durations.append(duration_s)
        return verdict

    @property
    def median(self) -> float:
        if not self.durations:
            return 0.0
        return sorted(self.durations)[len(self.durations) // 2]
