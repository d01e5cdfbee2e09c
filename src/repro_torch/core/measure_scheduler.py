"""Adaptive multi-queue measurement scheduling (the JAX package's
``core/measure_scheduler.py``, ported).

Measurement, not search, dominates tuning wall-time on real hardware. This
module lets the tuner keep measurement batches from many drivers in flight
while the host evolves the next generation. The pieces:

- **Async submission protocol** (duck-typed on ``Runner``): a runner may
  expose ``submit_batch(workload, schedules) -> ticket`` returning a
  :class:`MeasureTicket` (a future: ``done()``/``result()``) plus a
  ``max_inflight`` capacity hint — how many submitted batches can make
  *physical* progress concurrently (1 for one card). Backends that
  additionally declare ``supports_priority`` accept a ``priority=`` keyword
  on ``submit_batch`` and dispatch higher-priority batches first. No runner
  of the port has a native ``submit_batch`` yet (the JAX package's board
  farm is not ported); the native path is kept for when one does.
- :class:`SerialMeasureQueue` — the default adapter wrapping any synchronous
  ``run_batch`` runner (``CudaRunner``, ``EmulateRunner``,
  ``AnalyticRunner``) behind one measurement thread. The queue is
  priority-ordered (FIFO within a priority class); with every submission at
  the default priority it is the single-FIFO pipeline (the determinism
  baseline). On the card the thread launches every kernel of the batch on
  the default stream of device 0, and a kernel fault it hits fails the
  ticket, so ``result()`` re-raises it in the tuning thread.
- :class:`MeasureScheduler` — holds many tickets from many submitters
  (drivers) in flight at once, hands back completed batches **per-submitter
  FIFO** (the determinism contract: each driver reconciles its own batches
  in submission order; *which* driver reconciles next may follow completion
  and priority, which never leaks into any driver's trajectory), and tracks
  real busy/wait *intervals* — per submitter — so measurement/search
  overlap, utilization, and per-driver wait attribution are span-accurate
  under concurrency instead of estimated from summed totals.
- :class:`AdaptiveDepthPolicy` — the utilization-driven speculation-depth
  controller ``tuner.run_scheduled`` consults when adaptation is enabled.
  It grows a driver's effective depth beyond the requested
  ``pipeline_depth`` (bounded by ``max_depth`` and the backend's
  ``max_inflight`` hint) while the backend's busy-fraction over a sliding
  window sits below target, and shrinks it back toward the base depth when
  reconciliation lag — batches evolved against constant-liar predictions
  that were later corrected — exceeds a threshold. The policy never reads a
  clock: its "now" is derived from the scheduler's recorded span intervals
  (:meth:`MeasureScheduler.busy_fraction`), so an adaptive run is
  reproducible given a scripted clock, and ``tools/lint_invariants.py``
  structurally forbids wall-clock reads inside policy classes. Adaptation
  is **off by default**: with it disabled, fixed-seed histories are
  bit-identical to the non-adaptive scheduler.

``tuner.run_scheduled`` (and through it ``tune`` and ``TuningSession``) is
built on this scheduler.

Statically-invalid work is refused before it reaches a backend: schedules
the feasibility analyzer (``core/static_analysis.py``) proves can never
validate come back ``INVALID`` from a screened ticket without occupying the
measurement thread (``static_rejected`` counts them). Backends that screen
natively (``static_screens``) are left to do it themselves so rejections
are counted exactly once.

Caching lives *below* this layer: the content-addressed build cache
(``core/build_cache.py``) belongs to the backends, which always fulfil
tickets position-aligned with the submitted schedules — so the scheduler's
per-submitter FIFO reconciliation and determinism contract are untouched
by whether a backend rebuilt a candidate or reused it.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Any, Sequence

from repro_torch.core import static_analysis as static_lib
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload

# local copy of runner.INVALID (the runner module is imported lazily here —
# see SerialMeasureQueue._loop — to keep this module import-light)
_INVALID = float("inf")


class MeasureTicket:
    """A future for one submitted measurement batch.

    ``t_start``/``t_end`` bracket when the backend *actually* measured the
    batch (first dispatch to completion), not when it sat queued — the raw
    material for span-accurate overlap accounting. Backends fulfil a ticket
    with :meth:`_complete` (latencies aligned with the submitted schedules)
    or :meth:`_fail` (an exception ``result()`` re-raises, e.g. a kernel
    fault on the card).
    """

    def __init__(self, workload: Workload, schedules: Sequence[Schedule]):
        self.workload = workload
        self.schedules = list(schedules)
        self.t_start: float | None = None  # measurement actually began
        self.t_end: float | None = None
        self._event = threading.Event()
        self._listeners: list[threading.Event] = []
        self._latencies: list[float] | None = None
        self._error: BaseException | None = None

    # ---- backend side ----------------------------------------------------------
    def _mark_started(self) -> None:
        if self.t_start is None:
            self.t_start = time.monotonic()

    def _notify(self) -> None:
        self._event.set()
        for listener in list(self._listeners):
            listener.set()

    def _complete(self, latencies: Sequence[float]) -> None:
        self._mark_started()
        self.t_end = time.monotonic()
        self._latencies = list(latencies)
        self._notify()

    def _fail(self, error: BaseException) -> None:
        self.t_end = time.monotonic()
        self._error = error
        self._notify()

    def subscribe(self, event: threading.Event) -> None:
        """Register a shared wake-up event set on completion (the
        scheduler's wait-for-any primitive). Consumers must tolerate a
        spurious or slightly-late wake (they re-scan on wake anyway)."""
        self._listeners.append(event)
        if self._event.is_set():
            event.set()

    # ---- consumer side ---------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> list[float]:
        if not self._event.wait(timeout):
            raise TimeoutError("measurement ticket not fulfilled in time")
        if self._error is not None:
            raise self._error
        assert self._latencies is not None
        return self._latencies

    @property
    def measure_s(self) -> float:
        """Wall-clock the backend spent on this batch (0 until fulfilled)."""
        if self.t_start is None or self.t_end is None:
            return 0.0
        return max(0.0, self.t_end - self.t_start)

    def interval(self) -> tuple[float, float] | None:
        if self.t_start is None or self.t_end is None:
            return None
        return (self.t_start, self.t_end)


class _ScreenedTicket(MeasureTicket):
    """Ticket for a statically screened batch: the backend only measured
    the kept subset, and ``result()`` re-inserts ``INVALID`` at the
    rejected positions so the latency list stays aligned with the batch the
    caller submitted (consumers index ``result()`` by submission position).
    With nothing kept there is no inner ticket at all — the batch completes
    immediately without touching the backend."""

    def __init__(self, workload, schedules, inner: MeasureTicket | None,
                 keep: Sequence[int]):
        super().__init__(workload, schedules)
        self._inner = inner
        self._keep = list(keep)
        if inner is None:
            self._complete([_INVALID] * len(self.schedules))

    def subscribe(self, event: threading.Event) -> None:
        if self._inner is None:
            super().subscribe(event)
        else:
            self._inner.subscribe(event)

    def done(self) -> bool:
        if self._inner is None:
            return super().done()
        return self._inner.done()

    def result(self, timeout: float | None = None) -> list[float]:
        if self._inner is None:
            return super().result(timeout)
        kept = self._inner.result(timeout)
        merged = [_INVALID] * len(self.schedules)
        for idx, lat in zip(self._keep, kept):
            merged[idx] = lat
        return merged

    @property
    def measure_s(self) -> float:
        if self._inner is None:
            return 0.0  # nothing was measured; charge no backend time
        return self._inner.measure_s

    def interval(self) -> tuple[float, float] | None:
        if self._inner is None:
            return None
        return self._inner.interval()


class SerialMeasureQueue:
    """Default async adapter: one measurement thread over a synchronous
    runner, packaged behind the submission protocol so runners without a
    native ``submit_batch`` need no changes. ``max_inflight = 1``: extra
    submissions queue behind the single measurement thread.

    The queue is priority-ordered: a later high-priority submission is
    measured before earlier default-priority backlog (FIFO within a
    priority class, so all-default-priority traffic reproduces the old
    single-FIFO pipeline exactly — the determinism baseline the multi-queue
    benchmarks compare against). An in-progress batch is never interrupted;
    preemption is at batch granularity."""

    max_inflight = 1
    supports_priority = True

    def __init__(self, runner):
        self.runner = runner
        # entries: (-priority, submission seq, ticket); the close sentinel
        # sorts last so pending work drains before the thread exits
        self._q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self._thread: threading.Thread | None = None
        self._closed = False

    @property
    def hw(self):
        """The wrapped runner's hardware config (None when it has none) —
        what the scheduler screens statically-invalid work against."""
        return getattr(self.runner, "hw", None)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="measure-serial")
            self._thread.start()

    def _loop(self) -> None:
        from repro_torch.core.runner import run_batch as _run_batch

        while True:
            _, _, ticket = self._q.get()
            if ticket is None:  # close sentinel (sorts after pending work)
                return
            ticket._mark_started()
            try:
                lats = _run_batch(self.runner, ticket.workload,
                                  ticket.schedules)
            except BaseException as e:  # surfaced at ticket.result()
                ticket._fail(e)
            else:
                ticket._complete(lats)

    def submit_batch(self, workload: Workload,
                     schedules: Sequence[Schedule],
                     priority: int = 0) -> MeasureTicket:
        if self._closed:
            raise RuntimeError("measurement queue is closed")
        ticket = MeasureTicket(workload, schedules)
        self._ensure_thread()
        self._q.put((-int(priority), next(self._seq), ticket))
        return ticket

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._q.put((float("inf"), next(self._seq), None))
            self._thread.join(timeout=5.0)
            self._thread = None


def _union_length(intervals: Sequence[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _clipped_length(intervals: Sequence[tuple[float, float]],
                    lo: float, hi: float) -> float:
    """Summed (not unioned) interval length inside [lo, hi] — interval
    overlap is concurrency, which the busy-fraction signal wants counted."""
    total = 0.0
    for a, b in intervals:
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


class _Entry:
    """One in-flight submission; ordering is the _fifo deque's position."""

    __slots__ = ("key", "batch", "ticket", "priority")

    def __init__(self, key, batch, ticket, priority=0):
        self.key, self.batch, self.ticket = key, batch, ticket
        self.priority = priority


class MeasureScheduler:
    """Hold measurement batches from several submitters in flight at once.

    ``submit(key, workload, schedules, priority=0)`` pushes one batch for
    submitter ``key`` (a driver index, a baseline slot, ...);
    ``collect_next()`` blocks for the next reconcilable batch and returns
    ``(key, batch, latencies, wait_s, measure_s)``. Ordering guarantees:

    - **per-key FIFO** — a key's batches always come back in its own
      submission order (what deterministic trace replay requires);
    - **completion- and priority-aware across keys** — if any in-flight
      ticket has already completed, the highest-priority (then
      earliest-*submitted*) completed one is returned without blocking, so
      its submitter can be topped up immediately; only when nothing is
      ready does the call block on the oldest outstanding work. Which key
      is picked is a wall-clock observation, but it can never change any
      single key's reconcile order — per-key trajectories stay
      bit-identical to the single-FIFO schedule.

    ``priority`` is forwarded to backends that declare
    ``supports_priority`` (the serial queue), so a high-priority batch also
    jumps the *backend's* queue, preempting bulk work at batch
    granularity.

    ``multi_queue=None`` (auto) uses the runner's native ``submit_batch``
    when it has one (none of the port's runners does yet); pass
    ``False`` to force the single-FIFO :class:`SerialMeasureQueue` even
    then (the comparison baseline). ``True`` *requests* the native path but
    degrades to the serial queue when the runner has none — check the
    resulting ``multi_queue`` attribute for the effective mode.

    The scheduler records every ticket's real measuring interval and every
    interval the consuming thread spent *blocked* in ``collect_next`` —
    attributed to the key whose batch the wait produced — so
    :meth:`overlap_s`, :meth:`measure_span_s`, and :meth:`wait_span_s` are
    span-accurate both globally and per key, and :meth:`busy_fraction`
    derives the utilization signal the adaptive depth policy consumes
    without any policy-side clock read.
    """

    def __init__(self, runner, multi_queue: bool | None = None):
        native = callable(getattr(runner, "submit_batch", None))
        self.multi_queue = native if multi_queue is None \
            else bool(multi_queue and native)
        if self.multi_queue:
            self._backend, self._owns_backend = runner, False
        else:
            self._backend, self._owns_backend = SerialMeasureQueue(runner), True
        self.max_inflight = max(1, int(getattr(self._backend,
                                               "max_inflight", 1)))
        self._priority_backend = bool(getattr(self._backend,
                                              "supports_priority", False))
        self._fifo: deque[_Entry] = deque()  # global submission order
        self._any_done = threading.Event()  # set whenever any ticket lands
        self._measure_ivs: dict[Any, list[tuple[float, float]]] = {}
        self._wait_ivs: dict[Any, list[tuple[float, float]]] = {}
        # schedules refused before reaching the backend because the static
        # analyzer proved them infeasible (their slots return INVALID
        # without burning measurement time); see _screen
        self.static_rejected = 0

    # ---- submission ------------------------------------------------------------
    def _screen(self, workload: Workload,
                schedules: Sequence[Schedule]) -> list[bool] | None:
        """Per-schedule statically-provably-invalid verdicts, or None when
        screening doesn't apply (the backend screens natively, carries no
        hardware config, or nothing would be rejected)."""
        if getattr(self._backend, "static_screens", False):
            return None  # the backend refuses invalid work itself
        hw = getattr(self._backend, "hw", None)
        if hw is None:
            return None
        report = static_lib.feasibility(workload, hw)
        if report is None or not report.exhaustive:
            return None
        try:
            verdicts = [bool(report.check_schedule(s)) for s in schedules]
        except Exception:
            return None  # unscreenable schedules: let the backend decide
        return verdicts if any(verdicts) else None

    def _submit_backend(self, workload: Workload,
                        schedules: list[Schedule],
                        priority: int) -> MeasureTicket:
        if self._priority_backend:
            return self._backend.submit_batch(workload, schedules,
                                              priority=priority)
        return self._backend.submit_batch(workload, schedules)

    def submit(self, key: Any, workload: Workload,
               schedules: Sequence[Schedule],
               priority: int = 0) -> MeasureTicket:
        schedules = list(schedules)
        verdicts = self._screen(workload, schedules)
        if verdicts is None:
            ticket = self._submit_backend(workload, list(schedules), priority)
        else:
            # ship only the statically-defensible subset; the rejected
            # slots come back INVALID without occupying the backend at all
            keep = [i for i, bad in enumerate(verdicts) if not bad]
            self.static_rejected += len(schedules) - len(keep)
            inner = None
            if keep:
                inner = self._submit_backend(
                    workload, [schedules[i] for i in keep], priority)
            ticket = _ScreenedTicket(workload, schedules, inner, keep)
        ticket.subscribe(self._any_done)
        self._fifo.append(_Entry(key, schedules, ticket, priority))
        return ticket

    def inflight(self, key: Any = None) -> int:
        if key is None:
            return len(self._fifo)
        return sum(1 for e in self._fifo if e.key == key)

    def _next_ready(self) -> "_Entry | None":
        """Highest-priority, then earliest-submitted, completed entry that
        is also its key's oldest in-flight entry (the per-key FIFO
        eligibility rule — a key's later completions wait for its head)."""
        blocked: set = set()
        best: _Entry | None = None
        for entry in self._fifo:
            if entry.key in blocked:
                continue
            # only a key's oldest in-flight entry is ever eligible,
            # completed or not
            blocked.add(entry.key)
            if entry.ticket.done() and (best is None
                                        or entry.priority > best.priority):
                best = entry  # fifo scan: earliest wins within a priority
        return best

    # ---- collection ------------------------------------------------------------
    def collect_next(self) -> tuple[Any, list[Schedule], list[float],
                                    float, float]:
        """Block for the next reconcilable batch (see class docstring for
        the ordering contract); raises whatever the backend failed the
        ticket with (e.g. a kernel fault on the card)."""
        if not self._fifo:
            raise RuntimeError("collect_next() with nothing in flight")
        t0 = time.monotonic()
        # Wait until some key's HEAD ticket completes, then take the
        # highest-priority earliest-submitted such entry — never block on
        # the global head while a later ticket's submitter could be topped
        # up. Only a key's oldest in-flight entry is eligible (per-key
        # FIFO: a driver whose second batch finished before its first must
        # wait for the first), and the clear-then-rescan pattern makes a
        # racing completion at worst one poll-timeout late.
        while True:
            entry = self._next_ready()
            if entry is not None:
                break
            self._any_done.clear()
            entry = self._next_ready()
            if entry is not None:
                break
            self._any_done.wait(timeout=0.1)
        self._fifo.remove(entry)
        try:
            latencies = entry.ticket.result()
        finally:
            t1 = time.monotonic()
            if t1 > t0:
                # the blocked interval is attributed to the key whose batch
                # the wait produced — per-driver wait spans stay meaningful
                # in an interleaved session (satellite: wait_span_s(key=))
                self._wait_ivs.setdefault(entry.key, []).append((t0, t1))
            iv = entry.ticket.interval()
            if iv is not None:
                self._measure_ivs.setdefault(entry.key, []).append(iv)
        return (entry.key, entry.batch, latencies, t1 - t0,
                entry.ticket.measure_s)

    # ---- span accounting -------------------------------------------------------
    def _intervals(self, key: Any = None) -> list[tuple[float, float]]:
        if key is None:
            return [iv for ivs in self._measure_ivs.values() for iv in ivs]
        return list(self._measure_ivs.get(key, ()))

    def _waits(self, key: Any = None) -> list[tuple[float, float]]:
        if key is None:
            return [iv for ivs in self._wait_ivs.values() for iv in ivs]
        return list(self._wait_ivs.get(key, ()))

    def measure_span_s(self, key: Any = None) -> float:
        """Wall-clock during which the backend was measuring (union of the
        collected tickets' real intervals — not a sum, so concurrent
        batches are not double-counted)."""
        return _union_length(self._intervals(key))

    def wait_span_s(self, key: Any = None) -> float:
        """Wall-clock the consuming thread spent blocked on tickets —
        for one key, only the blocked intervals that produced *that key's*
        batches (per-driver wait attribution in interleaved sessions; the
        keyless form is the union across all keys, as before)."""
        return _union_length(self._waits(key))

    def overlap_s(self, key: Any = None) -> float:
        """Measurement wall-time hidden behind other (search) work: the
        measuring span minus the part of it the consumer spent blocked —
        by inclusion-exclusion, |measure ∪ wait| − |wait| (measuring time
        that fell outside every wait interval). Per key, both spans are
        that key's own (its batches, the waits that produced them)."""
        ivs = self._intervals(key)
        waits = self._waits(key)
        return max(0.0, _union_length(ivs + waits) - _union_length(waits))

    def busy_fraction(self, window_s: float = 2.0) -> float:
        """Mean measuring concurrency over the trailing window, relative to
        the backend's ``max_inflight`` capacity — the utilization signal
        the adaptive depth policy consumes.

        Derived **entirely from recorded span intervals**: "now" is the
        latest recorded interval edge (or an in-flight ticket's start), not
        a clock read, so the signal is reproducible under a scripted clock
        and the policy layer on top of it stays free of wall-clock reads
        (enforced by ``tools/lint_invariants.py``). In-flight tickets count
        as busy from their real dispatch start to the derived now. Returns
        0.0 before any measurement has started; capped at 1.0 (ticket
        concurrency can exceed the backend's capacity transiently)."""
        done = self._intervals()
        open_ivs = [(e.ticket.t_start, None) for e in self._fifo
                    if e.ticket.t_start is not None and not e.ticket.done()]
        edges = [b for _, b in done] + [a for a, _ in open_ivs]
        edges += [b for _, b in self._waits()]
        if not edges:
            return 0.0
        now = max(edges)
        starts = [a for a, _ in done] + [a for a, _ in open_ivs]
        horizon = max(1e-9, min(float(window_s), now - min(starts)))
        lo = now - horizon
        busy = _clipped_length(done, lo, now)
        busy += _clipped_length([(a, now) for a, _ in open_ivs], lo, now)
        return min(1.0, busy / (horizon * self.max_inflight))

    # ---- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._owns_backend:
            self._backend.close()

    def __enter__(self) -> "MeasureScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AdaptiveDepthPolicy:
    """Utilization-driven speculation-depth controller (off by default in
    every entry point — ``tune``/``TuningSession`` construct one only when
    asked, so fixed-seed histories stay bit-identical to the non-adaptive
    scheduler unless adaptation is explicitly enabled).

    ``tuner.run_scheduled`` asks :meth:`depth` for each driver's current
    effective depth before topping it up and calls :meth:`on_collect` after
    every reconcile. The controller:

    - **grows** a driver's depth by one — beyond the requested
      ``base_depth``, up to ``min(max_depth, max_inflight + 1)`` — when the
      backend's busy-fraction over the trailing ``window_s`` sits below
      ``target_utilization`` (the backend is starving at the current depth
      boundary) — but never while mean reconciliation lag is already over
      ``lag_threshold``, so lag-shrink and idle-grow cannot saw against
      each other at the base depth;
    - **shrinks** it back toward ``base_depth`` when the driver's mean
      reconciliation lag (batches it proposed against constant-liar
      predictions that were still uncorrected when this batch reconciled)
      exceeds ``lag_threshold`` — deep speculation on stale predictions
      degrades search quality faster than it fills the backend;
    - changes at most once per ``cooldown`` reconciles per driver, so one
      noisy window reading cannot saw the depth.

    Determinism: the policy reads only the scheduler's recorded span
    intervals (see :meth:`MeasureScheduler.busy_fraction`) and per-driver
    reconcile counts — never a clock (``tools/lint_invariants.py`` forbids
    wall-clock reads inside ``*Policy``/``*Ledger`` classes). Given a
    scripted clock an adaptive run replays reproducibly; with the policy absent the scheduler loop is
    untouched.
    """

    def __init__(self, base_depth: int, max_depth: int = 8,
                 target_utilization: float = 0.75, window_s: float = 2.0,
                 lag_threshold: float = 4.0, cooldown: int = 2):
        self.base_depth = max(1, int(base_depth))
        self.max_depth = max(self.base_depth, int(max_depth))
        self.target_utilization = float(target_utilization)
        self.window_s = float(window_s)
        self.lag_threshold = float(lag_threshold)
        self.cooldown = max(1, int(cooldown))
        self._depths: dict[Any, int] = {}
        self._lags: dict[Any, deque] = {}
        self._since_change: dict[Any, int] = {}
        # (collect ordinal, key, depth) rows for every change — the raw
        # material of TuneResult.depth_trace and tests
        self.events: list[tuple[int, Any, int]] = []
        self._collects = 0

    def depth(self, key: Any) -> int:
        """Current effective speculation depth for ``key``."""
        return self._depths.get(key, self.base_depth)

    def on_collect(self, key: Any, scheduler: MeasureScheduler,
                   lag: int) -> None:
        """Fold one reconcile into the controller: ``lag`` is how many of
        ``key``'s batches were still in flight (proposed against the
        constant liar) when the collected batch reconciled."""
        self._collects += 1
        self._lags.setdefault(key, deque(maxlen=8)).append(max(0, int(lag)))
        since = self._since_change.get(key, self.cooldown) + 1
        self._since_change[key] = since
        if since < self.cooldown:
            return
        depth = self.depth(key)
        cap = min(self.max_depth,
                  max(self.base_depth, scheduler.max_inflight + 1))
        lags = self._lags[key]
        mean_lag = sum(lags) / len(lags)
        if mean_lag > self.lag_threshold and depth > self.base_depth:
            self._set(key, depth - 1)
        elif depth < cap and mean_lag <= self.lag_threshold and \
                scheduler.busy_fraction(self.window_s) \
                < self.target_utilization:
            self._set(key, depth + 1)
        elif depth > cap:  # backend shrank: clamp down
            self._set(key, cap)

    def _set(self, key: Any, depth: int) -> None:
        self._depths[key] = depth
        self._since_change[key] = 0
        self.events.append((self._collects, key, depth))
