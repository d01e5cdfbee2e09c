"""Simulated-board harness helpers for the port's farm suites (the port's
counterpart of tests/_sim_boards.py, over the port's ``AnalyticRunner``,
which is the reference's copied bit for bit).

Builders for scripted :class:`~repro_torch.core.board_farm.SimulatedBoard`
farms plus a recording measurement function that lets tests assert
exactly-once / requeue properties from what each board actually measured.
"""

import functools
import threading
from collections import Counter

from repro_torch.core import V5E, AnalyticRunner
from repro_torch.core.board_farm import Fault, simulated_farm


class RecordingMeasure:
    """Deterministic analytic measurement that counts, thread-safely, how
    often each candidate was measured (by schedule signature) — the ground
    truth for exactly-once and wasted-work assertions."""

    def __init__(self, hw=V5E):
        self._runner = AnalyticRunner(hw)
        self._lock = threading.Lock()
        self.calls = Counter()

    def __call__(self, workload, schedule):
        with self._lock:
            self.calls[schedule.signature()] += 1
        return self._runner.run(workload, schedule)


# Farm of n simulated boards on V5E; faults/respawns map board index ->
# fault script / respawn budget (see core.board_farm.simulated_farm).
make_farm = functools.partial(simulated_farm, hw=V5E)


# The simulated board configurations the determinism cases sweep: (name,
# board count, per-board delays, capacity), the reference's own. Delays are
# small but deliberately skewed so completion order genuinely varies.
DETERMINISM_CONFIGS = [
    ("uniform-2", 2, [0.001, 0.001], 1),
    ("skewed-3", 3, [0.0, 0.004, 0.001], 1),
    ("wide-4", 4, [0.002, 0.0, 0.003, 0.001], 2),
]


def die_fault(batch, after=0):
    return Fault(batch=batch, kind="die", after=after)


def hang_fault(batch, cap_s=30.0):
    return Fault(batch=batch, kind="hang", value=cap_s)


def garbage_fault(batch, value=-1.0):
    return Fault(batch=batch, kind="garbage", value=value)
