"""Straggler tracking for the training launcher.

A copy of `StragglerMitigator` from the JAX package's
`runtime/fault_tolerance.py` (the launcher needs it and nothing else
from that module): an EWMA of each worker's step time, and the workers
whose EWMA exceeds `threshold` x the median, once at least three
workers have `min_steps` samples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class StragglerMitigator:
    threshold: float = 1.5     # x median EWMA step time
    alpha: float = 0.3
    min_steps: int = 5
    ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    counts: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, worker: int, step_time: float) -> None:
        prev = self.ewma.get(worker, step_time)
        self.ewma[worker] = (1 - self.alpha) * prev + self.alpha * step_time
        self.counts[worker] = self.counts.get(worker, 0) + 1

    def stragglers(self) -> List[int]:
        ready = {w: t for w, t in self.ewma.items()
                 if self.counts[w] >= self.min_steps}
        if len(ready) < 3:
            return []
        med = float(np.median(list(ready.values())))
        return sorted(w for w, t in ready.items()
                      if t > self.threshold * med)
