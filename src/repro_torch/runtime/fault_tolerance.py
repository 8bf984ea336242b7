"""Fault tolerance and elasticity: worker liveness, elastic mesh plans,
straggler tracking and the checkpoint/restart driver loop.

A copy of the JAX package's `runtime/fault_tolerance.py` (NumPy and the
standard library only; the port keeps its own copy so that nothing here
imports JAX).  All of it is host-side:

- `Heartbeat`: worker liveness with a timeout; `evict` forgets a worker
  the coordinator has acted on, so `dead()` stops reporting it.
- `ElasticPlan`: from the live worker count, the largest usable mesh
  (power-of-two data axis; the model axis is kept, the pod axis shrunk
  before giving up).  Its `mesh_shape` and `mesh_axes` feed
  `launch.mesh.make_auto_mesh`, and the new mesh's `state_shardings`
  place the restored checkpoint (`checkpoint.restore(shardings=...)`).
- `StragglerMitigator`: an EWMA of each worker's step time; a worker
  slower than `threshold` x the median is flagged.
- `run_with_recovery`: step, checkpoint every K, and on a failure
  restore the latest checkpoint and continue (exactly reproducible,
  since the data pipeline is step-indexed); the metrics log is rolled
  back with the state, and `max_restarts` bounds the retries.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    timeout_s: float = 30.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None) -> None:
        # a live heartbeat needs a real clock when the caller does not
        # inject one; tests pass `now` explicitly and stay deterministic
        self.last_seen[worker] = (time.monotonic()  # lint: disable=det-wallclock
                                  if now is None else now)

    def dead(self, now: Optional[float] = None) -> List[int]:
        t = (time.monotonic()  # lint: disable=det-wallclock (see beat)
             if now is None else now)
        return sorted(w for w, s in self.last_seen.items()
                      if t - s > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> List[int]:
        t = (time.monotonic()  # lint: disable=det-wallclock (see beat)
             if now is None else now)
        return sorted(w for w, s in self.last_seen.items()
                      if t - s <= self.timeout_s)

    def evict(self, worker: int) -> None:
        """Forget a worker the coordinator has acted on.  Without this,
        `dead()` re-reports the same failed worker on every poll and the
        restart policy re-fires forever."""
        self.last_seen.pop(worker, None)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_workers: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]

    @staticmethod
    def plan(n_alive_chips: int, model_parallel: int,
             pods: int = 1) -> "ElasticPlan":
        """Largest power-of-two data axis that fits the survivors; the
        model axis is preserved (TP weights are not re-shardable in-run).
        The pod axis IS shrinkable (pods are replicas): it participates
        in the feasibility check and is reduced before giving up, so the
        plan never claims more workers than there are alive chips."""
        if model_parallel < 1 or pods < 1:
            raise ValueError("model_parallel and pods must be >= 1")
        if n_alive_chips < model_parallel:
            raise RuntimeError(
                f"cannot keep model_parallel={model_parallel} with only "
                f"{n_alive_chips} chips")
        while pods > 1 and pods * model_parallel > n_alive_chips:
            pods -= 1
        data = 1
        while data * 2 * model_parallel * pods <= n_alive_chips:
            data *= 2
        if pods > 1:
            return ElasticPlan(pods * data * model_parallel,
                               (pods, data, model_parallel),
                               ("pod", "data", "model"))
        return ElasticPlan(data * model_parallel, (data, model_parallel),
                           ("data", "model"))


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


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str          # "failure" | "straggler"
    workers: List[int]
    new_mesh: Tuple[int, ...]


def run_with_recovery(step_fn: Callable, state, n_steps: int,
                      batch_fn: Callable[[int], dict],
                      save_fn: Callable[[dict, int], None],
                      restore_fn: Callable[[], Tuple[dict, int]],
                      checkpoint_every: int = 10,
                      failure_injector: Optional[Callable[[int], bool]] = None,
                      max_restarts: int = 25,
                      ) -> Tuple[dict, List[RecoveryEvent], list]:
    """Driver loop with checkpoint/restart.  `failure_injector(step)` lets
    tests kill the run deterministically; production wires it to the
    heartbeat registry.

    Restores rewind `step` to the latest checkpoint, so any metrics
    recorded past that point are rolled back too (replayed steps would
    otherwise append duplicates); on success ``len(metrics_log) ==
    n_steps`` exactly.  `max_restarts` bounds the retry loop: a
    deterministic injector that fires again at the restored step would
    otherwise spin forever."""
    events: List[RecoveryEvent] = []
    metrics_log = []
    step = 0
    restarts = 0
    while step < n_steps:
        try:
            if failure_injector is not None and failure_injector(step):
                raise RuntimeError(f"injected worker failure at step {step}")
            state, metrics = step_fn(state, batch_fn(step))
            metrics_log.append(metrics)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(state, step)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"run_with_recovery: exceeded max_restarts="
                    f"{max_restarts} at step {step}; the failure keeps "
                    f"recurring at the restored step (deterministic "
                    f"injector or persistently bad worker) — evict the "
                    f"worker or raise max_restarts")
            state, step = restore_fn()
            # roll the metrics log back with the state: entries for steps
            # >= the restore point are about to be replayed
            del metrics_log[step:]
            events.append(RecoveryEvent(step, "failure", [], ()))
    return state, events, metrics_log
