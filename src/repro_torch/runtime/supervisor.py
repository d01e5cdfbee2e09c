"""Fault-tolerance supervisor: restart-on-failure + straggler mitigation
(the JAX package's ``runtime/supervisor.py``, ported; it touches no
hardware, so it stays the reference's line for line).

At 1000+ node scale the loop must assume failures are routine. The
supervisor wraps a :class:`Trainer` with:

- **checkpoint/restart**: any exception in a step (preemption, device loss —
  injectable for tests) triggers a restore from the latest atomic checkpoint
  and a bounded number of resumes; the data pipeline state restores with it,
  so the recovered run re-consumes the exact token stream.
- **heartbeats**: a per-step timestamp file an external orchestrator (or the
  test suite) can watch for liveness.
- **straggler mitigation**: an EMA/median watchdog over step wall-times;
  steps beyond ``straggler_factor`` x median are flagged. The mitigations at
  scale are (a) logging for re-scheduling and (b) the documented
  drop-stragglers gradient option — here the watchdog plus its decision
  logic run for real, with delays injected in tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from typing import Callable

from repro_torch.runtime.train_loop import StepRecord, Trainer


class InjectedFailure(RuntimeError):
    """Stands in for a preemption / device loss in tests."""


@dataclasses.dataclass
class SupervisorReport:
    completed_steps: int
    restarts: int
    stragglers: list[int]
    losses: list[float]


class Supervisor:
    def __init__(self, trainer: Trainer, max_restarts: int = 3,
                 straggler_factor: float = 3.0,
                 heartbeat_path: str | None = None,
                 failure_hook: Callable[[int], None] | None = None,
                 delay_hook: Callable[[int], float] | None = None):
        self.trainer = trainer
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.heartbeat_path = heartbeat_path
        self.failure_hook = failure_hook or (lambda step: None)
        self.delay_hook = delay_hook or (lambda step: 0.0)
        self.restarts = 0
        self.stragglers: list[int] = []
        self._times: list[float] = []

    # ----------------------------------------------------------------------
    def _heartbeat(self, rec: StepRecord) -> None:
        if self.heartbeat_path:
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": rec.step, "loss": rec.loss,
                           "time": time.time()}, f)
            os.replace(tmp, self.heartbeat_path)

    def _watch(self, rec: StepRecord) -> None:
        self._times.append(rec.wall_s)
        if len(self._times) >= 5:
            med = statistics.median(self._times[-50:])
            if rec.wall_s > self.straggler_factor * med:
                self.stragglers.append(rec.step)

    # ----------------------------------------------------------------------
    def run(self, n_steps: int) -> SupervisorReport:
        target = self.trainer.step + n_steps
        while self.trainer.step < target:
            remaining = target - self.trainer.step
            try:
                self.trainer.run(remaining, step_callback=self._wrapped_step)
            except InjectedFailure:
                if self.restarts >= self.max_restarts:
                    raise
                self.restarts += 1
                if self.trainer.ckpt is not None \
                        and self.trainer.ckpt.latest_step() is not None:
                    self.trainer.restore_latest()
                else:
                    self.trainer.step = 0  # cold restart
        return SupervisorReport(
            completed_steps=self.trainer.step,
            restarts=self.restarts,
            stragglers=list(self.stragglers),
            losses=[r.loss for r in self.trainer.records],
        )

    def _wrapped_step(self, rec: StepRecord) -> None:
        delay = self.delay_hook(rec.step)
        if delay:
            time.sleep(delay)
            rec.wall_s += delay
        self._heartbeat(rec)
        self._watch(rec)
        self.failure_hook(rec.step)
