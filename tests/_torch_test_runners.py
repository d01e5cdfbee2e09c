"""Shared test runners for the port's tuner, session and network suites
(the port's counterpart of tests/_test_runners.py)."""

import time

from repro_torch.core import AnalyticRunner


class SlowAnalytic:
    """Deterministic analytic latencies behind an artificial measurement
    delay — the stand-in for a target that takes real time per batch.
    ``overlap_capable`` so the tuner pipeline and sessions treat it like
    real hardware; no ``max_inflight`` hint, as the reference's."""

    overlap_capable = True

    def __init__(self, hw, delay_s=0.01):
        self.hw = hw
        self.delay_s = delay_s
        self.name = "slow-analytic"
        self._inner = AnalyticRunner(hw)

    def run(self, workload, schedule):
        time.sleep(self.delay_s)
        return self._inner.run(workload, schedule)

    def run_batch(self, workload, schedules):
        time.sleep(self.delay_s)
        return self._inner.run_batch(workload, schedules)
