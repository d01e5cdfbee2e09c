"""Traffic-driven continuous tuning — the serving↔tuning loop (the JAX
package's ``core/traffic.py``, ported).

The paper's workflow tunes once per (workload, hardware) and ships the tuned
artifact; everything the database has never seen falls back to the fixed
library forever. Under live traffic that is exactly backwards: the shapes
that matter are the ones actually dispatched, not the ones anticipated
offline ("Closer the Gap", PAPERS.md). This module closes the loop:

- :class:`TrafficLog` — a bounded, deduplicating record of every dispatch
  cache miss / near miss (``fixed`` / ``bucketed`` / ``xla`` provenance,
  see ``core/dispatch.py``). Each unique (workload, hardware) shape carries
  a hit counter, so the log *is* the observed demand distribution of the
  serving process. Thread-safe: the serving thread records, the tuner
  thread drains.

- :class:`ContinuousTuner` — drains the log on a budget (hottest shapes
  first, hit count weighting the session's trial split), runs them through
  the existing :class:`~repro_torch.core.session.TuningSession` on whatever
  runner is attached (``CudaRunner`` on the card by default for a CUDA
  configuration, the analytic model for a TPU one, or ``EmulateRunner`` —
  measurement happens off the serving thread), and persists results via
  ``TuningDatabase.save``. A
  server dispatching through ``global_database()`` then hot-swaps to the
  new artifact on the next lookup (mtime/appearance detection in
  ``core/database.py``) — no restart, no ``reset_global_database()`` call.

The layer is **off by default**: no log is installed process-wide unless
:func:`set_traffic_log` is called (or an explicit ``traffic=`` log is
passed to ``best_schedule``), recording never touches the sampler or the
measurement path, and cycle seeds are ``seed + cycle`` — fixed-seed tuning
histories stay bit-identical whether or not traffic is being recorded.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from repro_torch.core.database import TuningDatabase
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class TrafficEntry:
    """One observed miss shape with its demand counters."""

    workload: Workload
    hw_name: str
    hits: int = 0
    # provenance -> count of the dispatches that produced the hits
    # ("fixed" / "bucketed" / "xla")
    by_provenance: dict[str, int] = dataclasses.field(default_factory=dict)
    seq: int = 0  # first-seen order; deterministic tiebreak for equal hits

    @property
    def key(self) -> str:
        return f"{self.workload.key()}@{self.hw_name}"


class TrafficLog:
    """Bounded, deduplicating log of dispatch misses under live traffic.

    ``record`` folds repeated sightings of the same (workload, hardware)
    shape into one entry's hit counter, so memory is bounded by *distinct*
    shapes, not request volume; ``capacity`` bounds the distinct shapes
    too — when full, a new shape evicts the coldest entry (fewest hits,
    oldest first: the demand distribution keeps its head, sheds its tail;
    ``evictions`` counts the shed). ``hottest``/``drain`` return entries
    most-hit first with first-seen order as the tiebreak, so a given
    record sequence always yields the same tuning order.

    All methods are thread-safe: the serving thread records while a
    :class:`ContinuousTuner` thread drains.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._entries: dict[str, TrafficEntry] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded = 0  # total record() hits folded in
        self.evictions = 0  # cold entries shed to keep the bound

    def record(self, workload: Workload, hw_name: str,
               provenance: str = "fixed", count: int = 1) -> None:
        """Fold one dispatch miss (or ``count`` at once — e.g. an op that
        occurs ``count`` times per serving step) into the log."""
        if count <= 0:
            return
        key = f"{workload.key()}@{hw_name}"
        with self._lock:
            self.recorded += count
            entry = self._entries.get(key)
            if entry is None:
                if len(self._entries) >= self.capacity:
                    coldest = min(
                        self._entries,
                        key=lambda k: (self._entries[k].hits,
                                       self._entries[k].seq))
                    del self._entries[coldest]
                    self.evictions += 1
                entry = self._entries[key] = TrafficEntry(
                    workload, hw_name, seq=self._seq)
                self._seq += 1
            entry.hits += count
            entry.by_provenance[provenance] = (
                entry.by_provenance.get(provenance, 0) + count)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pending(self, hw_name: str | None = None) -> int:
        """Distinct shapes waiting to be tuned (optionally for one hw)."""
        with self._lock:
            if hw_name is None:
                return len(self._entries)
            return sum(1 for e in self._entries.values()
                       if e.hw_name == hw_name)

    def hottest(self, n: int | None = None,
                hw_name: str | None = None) -> list[TrafficEntry]:
        """Up to ``n`` entries, most-hit first (non-destructive)."""
        with self._lock:
            entries = [e for e in self._entries.values()
                       if hw_name is None or e.hw_name == hw_name]
        entries.sort(key=lambda e: (-e.hits, e.seq))
        return entries if n is None else entries[:n]

    def drain(self, n: int | None = None,
              hw_name: str | None = None) -> list[TrafficEntry]:
        """Remove and return up to ``n`` hottest entries — what a tuning
        cycle consumes. Entries of other hardware configs stay logged."""
        with self._lock:
            entries = [e for e in self._entries.values()
                       if hw_name is None or e.hw_name == hw_name]
            entries.sort(key=lambda e: (-e.hits, e.seq))
            taken = entries if n is None else entries[:n]
            for e in taken:
                del self._entries[e.key]
        return taken

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# ---- process-wide installation ---------------------------------------------
# The log dispatch records misses into when no explicit ``traffic=`` is
# passed. None (the default) keeps the layer fully off: best_schedule then
# has zero tuning-side effects, exactly the pre-traffic dispatch.
_INSTALLED: TrafficLog | None = None


def set_traffic_log(log: TrafficLog | None) -> TrafficLog | None:
    """Install (or, with None, uninstall) the process-wide traffic log.
    Returns the previously installed log so callers can restore it."""
    global _INSTALLED
    previous, _INSTALLED = _INSTALLED, log
    return previous


def installed_log() -> TrafficLog | None:
    """The process-wide traffic log, or None when the layer is off."""
    return _INSTALLED


class ContinuousTuner:
    """Background tuner fed by a :class:`TrafficLog` — the system tunes
    itself against the traffic it actually serves.

    Each cycle drains up to ``max_shapes_per_cycle`` of the hottest
    observed shapes for this tuner's hardware and runs them through one
    :class:`~repro_torch.core.session.TuningSession` with a budget of
    ``trials_per_shape`` per shape. Hit counts ride along as the session's
    op multiplicities, so the shared trial budget is split by observed
    demand x flops — the hottest shape gets the deepest search. Results
    are committed (and, when the database has a path, atomically saved)
    by the session itself; a server dispatching through
    ``global_database()`` picks the new artifact up on its next lookup.

    ``tune_once()`` runs one cycle synchronously (tests, benchmarks, batch
    replay); ``start()``/``stop()`` run cycles on a daemon thread **off
    the serving thread**, polling the log every ``poll_interval_s``. Cycle
    seeds are ``seed + cycle`` so a replayed traffic sequence reproduces
    the same searches bit-identically. A cycle failure stops the thread
    and is re-raised by :meth:`wait_idle` instead of spinning silently.
    """

    def __init__(self, traffic: TrafficLog, hw: HardwareConfig,
                 runner=None, database: TuningDatabase | None = None,
                 db_path: str | None = None,
                 trials_per_shape: int = 16,
                 max_shapes_per_cycle: int = 4,
                 poll_interval_s: float = 0.25, seed: int = 0,
                 session_kwargs: dict[str, Any] | None = None,
                 log: Callable[[str], None] | None = None):
        self.traffic = traffic
        self.hw = hw
        self.runner = runner
        self.database = (database if database is not None
                         else TuningDatabase(db_path))
        self.trials_per_shape = max(1, int(trials_per_shape))
        self.max_shapes_per_cycle = max(1, int(max_shapes_per_cycle))
        self.poll_interval_s = float(poll_interval_s)
        self.seed = int(seed)
        self.session_kwargs = dict(session_kwargs or {})
        self.log = log
        self.cycles = 0  # tuning cycles completed
        self.shapes_tuned = 0  # traffic shapes consumed across cycles
        self.last_result = None  # SessionResult of the latest cycle
        self.error: BaseException | None = None  # what stopped the thread
        self._busy = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _ensure_runner(self):
        """The attached runner, or the default ``ensure_tuned`` picks:
        ``CudaRunner`` on the card for a CUDA configuration (raising
        without one), the analytic model for a TPU configuration."""
        if self.runner is None:
            from repro_torch.core.runner import default_runner  # lazy: cycles
            self.runner = default_runner(self.hw)
        return self.runner

    # ---- one synchronous cycle ---------------------------------------------
    def tune_once(self, max_shapes: int | None = None):
        """Drain and tune one cycle's worth of the hottest shapes; returns
        the :class:`SessionResult`, or None when nothing was pending."""
        from repro_torch.core.session import TuningSession  # lazy: cycle

        entries = self.traffic.drain(
            max_shapes if max_shapes is not None else
            self.max_shapes_per_cycle, hw_name=self.hw.name)
        if not entries:
            return None
        # hit counts become op multiplicities: the session splits its trial
        # budget by count * flops, so observed demand steers the search
        ops = [(entry.hits, entry.workload) for entry in entries]
        session = TuningSession(self.hw, self._ensure_runner(),
                                database=self.database, log=self.log,
                                **self.session_kwargs)
        result = session.tune_model(
            ops, total_trials=self.trials_per_shape * len(ops),
            seed=self.seed + self.cycles, model="continuous")
        self.cycles += 1
        self.shapes_tuned += len(entries)
        self.last_result = result
        return result

    # ---- background thread -------------------------------------------------
    def start(self) -> "ContinuousTuner":
        """Start the background tuning thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.error = None
        self._thread = threading.Thread(
            target=self._loop, name="continuous-tuner", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._busy = True
            try:
                if self.traffic.pending(self.hw.name):
                    self.tune_once()
            except BaseException as exc:  # surface via wait_idle, don't spin
                self.error = exc
                self._busy = False
                return
            self._busy = False
            self._stop.wait(self.poll_interval_s)

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the background thread (idempotent; pending traffic stays
        logged and can be drained by a later start() or tune_once())."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def wait_idle(self, timeout: float = 60.0,
                  poll_s: float = 0.02) -> bool:
        """Block until no traffic is pending for this hardware and no cycle
        is mid-flight (True), or ``timeout`` elapses (False). Re-raises a
        background-cycle failure instead of reporting idle."""
        deadline = time.monotonic() + timeout
        while True:
            if self.error is not None:
                raise RuntimeError(
                    "continuous tuning cycle failed") from self.error
            if not self.traffic.pending(self.hw.name) and not self._busy:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def __enter__(self) -> "ContinuousTuner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
