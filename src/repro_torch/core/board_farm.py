"""Multi-board measurement farm — the paper's RPC board pool as a Runner
(the JAX package's ``core/board_farm.py``, ported).

The paper measures candidates on a *farm* of FPGA-implemented RISC-V SoCs
reached over RPC: an AutoTVM-style tracker hands each measure batch to
whichever board is free, boards take 9-12 s per candidate, and boards drop
off the farm (bitstream reload, power glitch, wedged runtime) without
warning. The mapping here:

- :class:`Board`          ~ one FPGA SoC behind its RPC server: a name, a
  :class:`~repro_torch.core.hardware.HardwareConfig`, a dispatch capacity, and a
  health state the farm flips when the board misbehaves.
- :class:`LocalBoard`     ~ a board whose "RPC server" is a local
  :class:`~repro_torch.core.measure_pool.MeasurePool` (process-isolated
  measurement with a true per-candidate kill). On a CUDA configuration a
  board is one card, its pool one worker pinned to it: a candidate that
  faults or hangs on the card costs an ``INVALID`` and a worker respawn,
  never the farm.
- :class:`SimulatedBoard` ~ an in-process board with *scriptable* latency
  and failure behaviour (die mid-batch, hang past the deadline, return
  garbage, come back after a respawn) — the harness the fault-injection and
  determinism tests drive without hardware.
- :class:`BoardFarm`      ~ the tracker: a **persistent dispatcher** thread
  owns one shared work-stealing queue that spans batch boundaries. Batches
  enter through the async submission protocol
  (:meth:`BoardFarm.submit_batch` returns a
  :class:`~repro_torch.core.measure_scheduler.MeasureTicket`); an idle board
  pulls the next shard from the queue regardless of which in-flight batch
  — or which driver — the candidates came from, so boards never idle at a
  batch boundary while another batch has work queued. The farm enforces a
  per-board straggler deadline, requeues the candidates of a dead or
  abandoned board onto the survivors (bounded retries, then ``INVALID``)
  even when the dead board's shard mixed candidates from several batches,
  and fulfils every ticket with latencies aligned to its own submission
  order.

Determinism: each ticket's latencies are aligned with its submitted
schedules, and each candidate's latency is a function of the candidate
alone (every board measures against the same farm hardware config), so a
fixed tuner seed replays bit-identically regardless of which board finished
first, how shards were stolen across batches, or how often a flaky board
died. ``BoardFarm`` declares ``overlap_capable = True`` and satisfies both
the synchronous ``Runner`` protocol (``run_batch`` = submit + wait) and the
async submission protocol (``submit_batch`` + a ``max_inflight`` hint =
board count), so it drops into :func:`~repro_torch.core.tuner.tune` and
:class:`~repro_torch.core.session.TuningSession` unchanged — and lets the
:class:`~repro_torch.core.measure_scheduler.MeasureScheduler` keep every board
busy across workloads. Per-board utilization and requeue counts surface
through :meth:`BoardFarm.farm_summary` into ``TuneResult.board_stats`` and
session summaries; utilization is span-accurate (busy seconds over the
farm's *active* span, the union of periods with work in the system).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Sequence

from repro_torch.core import static_analysis as static_lib
from repro_torch.core.build_cache import build_cache_stats
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.measure_scheduler import MeasureTicket
from repro_torch.core.runner import INVALID
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload


class BoardDied(RuntimeError):
    """A board failed mid-batch (crash, RPC drop, scripted death)."""


class FarmDead(RuntimeError):
    """Every board is dead and unmeasured candidates remain — surfaced as an
    error so the tuner's FIFO queue fails fast instead of deadlocking."""


@dataclasses.dataclass
class BoardStats:
    """Per-board counters the farm maintains across ``run_batch`` calls."""

    dispatched: int = 0  # candidates handed to the board
    completed: int = 0  # candidates whose latencies were accepted
    requeued: int = 0  # candidates taken back (death / straggler)
    deaths: int = 0  # times the farm declared the board dead
    respawns: int = 0  # successful revivals after a death
    busy_s: float = 0.0  # wall-clock the board spent holding a shard


class Board:
    """One measurement target of the farm.

    ``capacity`` bounds the shard size one dispatch hands the board (the
    paper's boards measure one candidate at a time; a MeasurePool-backed
    board takes one per worker). ``timeout_s`` optionally overrides the
    farm's straggler deadline for this board alone (a slow-but-honest FPGA
    vs a fast simulator).
    """

    # Whether schedules dispatched here run through real space
    # concretization. Boards that measure via a custom task (which may
    # ignore the schedule entirely) set this False so the farm's static
    # screen never refuses their possibly-synthetic schedules.
    static_screenable = True

    def __init__(self, name: str, hw: HardwareConfig, capacity: int = 1,
                 timeout_s: float | None = None):
        self.name = name
        self.hw = hw
        self.capacity = max(1, int(capacity))
        self.timeout_s = timeout_s
        self.healthy = True
        self.stats = BoardStats()

    def measure(self, workload: Workload,
                schedules: Sequence[Schedule]) -> list[float]:
        """Latencies aligned with ``schedules``; raise :class:`BoardDied`
        when the board itself (not a candidate) fails."""
        raise NotImplementedError

    def measure_many(self, items: Sequence[tuple[Workload, Schedule]]
                     ) -> list[float]:
        """Measure a shard whose candidates may span *batches* — and
        therefore workloads (different drivers tune different workloads).
        The default groups consecutive same-workload runs into
        :meth:`measure` calls, preserving order; boards whose measurement
        host is per-candidate anyway (:class:`LocalBoard`) override it."""
        out: list[float] = []
        i = 0
        while i < len(items):
            wl = items[i][0]
            j = i
            while j < len(items) and items[j][0].key() == wl.key():
                j += 1
            out.extend(self.measure(wl, [s for _, s in items[i:j]]))
            i = j
        return out

    def abandon(self) -> None:
        """Farm gave up on the in-flight shard: wake/unblock a hung measure
        if the board can (best effort; the dispatch thread is daemonized)."""

    def respawn(self) -> bool:
        """Try to revive a dead board; True if it may serve again."""
        return False

    def close(self) -> None:
        """Release board resources."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted misbehaviour of a :class:`SimulatedBoard`.

    ``batch`` is the 0-based ordinal of the batch *on that board*; ``kind``
    is ``"die"`` (measure ``after`` candidates, then fail the shard),
    ``"hang"`` (block until abandoned, up to ``value`` seconds), or
    ``"garbage"`` (return ``value`` as every latency).
    """

    batch: int
    kind: str  # "die" | "hang" | "garbage"
    value: float = 0.0  # garbage latency / max hang seconds
    after: int = 0  # "die": candidates measured before the death


class SimulatedBoard(Board):
    """In-process board with scriptable latency and failure behaviour.

    Measurement is deterministic by default — each candidate's latency comes
    from ``measure_fn`` (an :class:`~repro_torch.core.runner.AnalyticRunner` over
    this board's hardware config unless overridden) — while ``delay_s``
    (a float, or a callable of the batch ordinal: a latency *script*)
    controls only how long the board pretends to take, and ``faults``
    injects failures. Wall-clock behaviour therefore varies per board; the
    returned values do not, which is exactly the property the farm's
    determinism guarantee rests on.
    """

    def __init__(self, name: str, hw: HardwareConfig, capacity: int = 1,
                 timeout_s: float | None = None,
                 delay_s: float | Callable[[int], float] = 0.0,
                 faults: Sequence[Fault] = (),
                 measure_fn: Callable[[Workload, Schedule], float] | None = None,
                 respawns: int = 0):
        super().__init__(name, hw, capacity, timeout_s)
        self.delay_s = delay_s
        self._faults = {f.batch: f for f in faults}
        self._measure_fn = measure_fn
        self._respawn_budget = respawns
        self._abandoned = threading.Event()
        self._batch_no = 0
        self.log: list[tuple[int, int, str]] = []  # (batch, n, status)

    def _latency(self, workload: Workload, schedule: Schedule) -> float:
        if self._measure_fn is None:
            from repro_torch.core.runner import AnalyticRunner

            self._measure_fn = AnalyticRunner(self.hw).run
        return self._measure_fn(workload, schedule)

    def measure(self, workload: Workload,
                schedules: Sequence[Schedule]) -> list[float]:
        batch = self._batch_no
        self._batch_no += 1
        fault = self._faults.get(batch)
        delay = (self.delay_s(batch) if callable(self.delay_s)
                 else self.delay_s)
        if fault is not None and fault.kind == "hang":
            self.log.append((batch, len(schedules), "hang"))
            # block like a wedged RPC call; the farm's straggler deadline
            # abandons us, abandon() sets the event, and we fail promptly
            # instead of pinning the dispatch thread for the full hang
            self._abandoned.wait(timeout=fault.value or 60.0)
            raise BoardDied(f"{self.name}: batch {batch} hung")
        if delay:
            time.sleep(delay)
        if fault is not None and fault.kind == "die":
            for s in schedules[:fault.after]:
                self._latency(workload, s)  # work wasted by the death
            self.log.append((batch, len(schedules), "die"))
            raise BoardDied(f"{self.name}: died on batch {batch}")
        lats = [self._latency(workload, s) for s in schedules]
        if fault is not None and fault.kind == "garbage":
            self.log.append((batch, len(schedules), "garbage"))
            return [fault.value] * len(lats)
        self.log.append((batch, len(schedules), "ok"))
        return lats

    def abandon(self) -> None:
        self._abandoned.set()

    def respawn(self) -> bool:
        if self._respawn_budget <= 0:
            return False
        self._respawn_budget -= 1
        # a fresh event: the abandoned (set) one keeps any still-waking hang
        # thread unblocked, while post-respawn hangs block anew
        self._abandoned = threading.Event()
        return True

    def close(self) -> None:
        self._abandoned.set()


class LocalBoard(Board):
    """A board whose measurement host is a local :class:`MeasurePool`.

    Candidates are built and timed in the pool's persistent worker
    processes (``CudaRunner`` on the board's card for a configuration that
    runs on the card, ``EmulateRunner`` otherwise), so a wedged or faulting
    candidate is killed or respawned by the pool inside the board —
    per-candidate failures surface as ``INVALID`` latencies, and only a
    board-level failure (no worker can be started) raises
    :class:`BoardDied`. ``respawn`` rebuilds the pool from scratch.

    On the card a board is card ``device`` (the first visible one when
    None) with one worker pinned to it; more workers raise, as does a
    board made where no card is visible.
    """

    def __init__(self, name: str, hw: HardwareConfig, workers: int = 1,
                 timeout_s: float | None = None, repeats: int = 3,
                 warmup: int = 1, candidate_timeout_s: float = 60.0,
                 mp_context: str = "spawn",
                 task: Callable[[Any], Any] | None = None,
                 device: int | None = None):
        super().__init__(name, hw, capacity=max(1, workers),
                         timeout_s=timeout_s)
        from repro_torch.core import measure_pool as mp_lib

        self.repeats = repeats
        self.warmup = warmup
        self.candidate_timeout_s = candidate_timeout_s
        self.mp_context = mp_context
        self._task = task if task is not None else mp_lib._measure_candidate
        self._cards = mp_lib._cards_for(hw, workers, mp_context, device)
        # a custom task never concretizes the schedule, so the static
        # screen has no say over what it can or cannot measure
        self.static_screenable = task is None
        self._pool: Any = None

    def _ensure_pool(self):
        from repro_torch.core import measure_pool as mp_lib

        if self._pool is None:
            self._pool = mp_lib.MeasurePool(
                self._task, workers=self.capacity,
                timeout_s=self.candidate_timeout_s,
                mp_context=self.mp_context,
                initializer=mp_lib._initializer(self.hw, self._task),
                devices=self._cards)
        return self._pool

    def measure(self, workload: Workload,
                schedules: Sequence[Schedule]) -> list[float]:
        return self.measure_many([(workload, s) for s in schedules])

    def measure_many(self, items: Sequence[tuple[Workload, Schedule]]
                     ) -> list[float]:
        """Native cross-batch shard support: the pool's payloads are
        per-candidate anyway, so a shard mixing workloads from different
        in-flight batches is one ``run_many`` call, no grouping."""
        pool = self._ensure_pool()
        payloads = [(self.hw, wl, s, self.repeats, self.warmup)
                    for wl, s in items]
        outcomes = pool.run_many(payloads)
        if outcomes and all(o.status == "crash" and not o.elapsed_s
                            for o in outcomes):
            # nothing ever ran: the host itself is down, not the candidates
            raise BoardDied(f"{self.name}: no pool worker could run")
        return [float(o.value) if o.ok and isinstance(o.value, (int, float))
                else INVALID for o in outcomes]

    def respawn(self) -> bool:
        self.close()
        return True

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None


class _FarmTicket(MeasureTicket):
    """One submitted batch: per-candidate results filled in as the farm's
    dispatcher completes (or gives up on) each candidate, fulfilled when
    the last one lands."""

    def __init__(self, workload: Workload, schedules: Sequence[Schedule]):
        super().__init__(workload, schedules)
        self.results: list[float | None] = [None] * len(self.schedules)
        self.remaining = len(self.schedules)
        # dedup fan-out: representative idx -> follower idxs that submitted
        # the same schedule signature and reuse its latency (farm dedup=True)
        self.aliases: dict[int, list[int]] = {}

    def _settle(self, idx: int, latency: float) -> bool:
        """Record one candidate's latency — and its dedup followers', when
        the farm collapsed same-signature candidates at submission; True
        when the batch completed. A follower settles with whatever its
        representative finally got, including ``INVALID`` after the
        representative exhausted its requeue retries."""
        for i in (idx, *self.aliases.get(idx, ())):
            if self.results[i] is None:
                self.results[i] = latency
                self.remaining -= 1
        if self.remaining == 0 and not self.done():
            self._complete([lat if lat is not None else INVALID
                            for lat in self.results])
            return True
        return False


@dataclasses.dataclass
class _WorkItem:
    """One candidate on the farm's shared cross-batch work queue."""

    ticket: _FarmTicket
    idx: int  # position within the ticket's batch
    workload: Workload
    schedule: Schedule
    attempts: int = 0
    priority: int = 0  # submission priority class (higher dispatches first)
    bypass: int = 0  # dispatch rounds a higher-priority item jumped this one


_WAKE = (None, "wake", None)  # queue sentinel: new work arrived
_STOP = (None, "stop", None)  # queue sentinel: farm closed


class BoardFarm:
    """Shard candidate batches across a pool of boards (the paper's tracker).

    Satisfies the synchronous ``Runner`` protocol (``run``/``run_batch``/
    ``name``/``hw``, with ``run_batch`` = submit + wait) *and* the async
    submission protocol (:meth:`submit_batch` returning a ticket,
    ``max_inflight`` = board count), and declares ``overlap_capable`` — so
    the tuner pipeline and interleaved sessions treat the farm like a
    single slow board, while the
    :class:`~repro_torch.core.measure_scheduler.MeasureScheduler` can hold many
    batches from many drivers in flight on it at once. The fan-out lives in
    a **persistent dispatcher** thread:

    - **cross-batch work stealing** — one shared queue spanning batch
      boundaries; every idle healthy board is handed the next ``capacity``
      candidates *from any in-flight batch*, so a fast board that drains
      one batch immediately pulls from the next instead of idling at the
      barrier (a shard may even mix candidates of different batches — and
      different workloads);
    - **stragglers** — a board that holds a shard past its deadline
      (``straggler_timeout_s`` or the board's own ``timeout_s``) is
      abandoned and declared dead; its dispatch thread is daemonized and
      its late result, should it ever arrive, is dropped by token;
    - **priority preemption** — ``submit_batch(..., priority=)`` tags every
      candidate; an idle board pulls the highest-effective-priority queued
      candidates first (queue order within a class), so a high-priority
      batch preempts bulk backlog at *shard* granularity — in-flight shards
      always finish, only queued candidates yield. Starvation is bounded by
      an aging credit: every dispatch round that jumps a queued candidate
      raises its effective priority by ``1/aging_every``, so bulk work
      eventually outranks a steady high-priority stream. With every
      submission at the default priority the pull order is exactly the old
      FIFO (the determinism baseline), and in all cases a candidate's
      *latency* is unaffected — priorities reorder completion, never
      results;
    - **dedup** (``dedup=True``, off by default) — same-signature
      candidates within a submitted batch collapse onto one
      representative; followers never occupy a board slot and settle off
      the representative's latency — through requeues and retry
      exhaustion alike — counted in ``farm_summary()['dedup_reused']``;
    - **requeue** — candidates of a dead/abandoned board go back on the
      queue for the survivors — including candidates the board held for
      several different batches — at most ``max_retries`` times each, then
      ``INVALID`` (a candidate that kills every board it touches must not
      circle forever);
    - **respawn** — a dead board gets up to ``max_respawns`` revival
      attempts (``Board.respawn``); until one succeeds it takes no work;
    - **reconciliation** — every ticket's latencies align with its own
      submitted order, so each driver reconciles per-driver FIFO and the
      search trajectory is independent of completion order;
    - **clean failure** — if every board is dead and candidates remain,
      every pending ticket fails with :class:`FarmDead` (``result()`` and
      ``run_batch`` raise it) instead of blocking the measurement queue.
    """

    overlap_capable = True
    # submit_batch accepts priority= and the dispatcher honours it
    supports_priority = True
    # the farm refuses statically-invalid work itself (no scheduler-side
    # screening needed — rejections are counted exactly once, here)
    static_screens = True
    # idle dispatcher threads exit after this grace (a fresh submit
    # respawns one), so an unclosed farm never parks a thread forever
    _IDLE_EXIT_S = 0.5

    def __init__(self, boards: Sequence[Board], hw: HardwareConfig | None = None,
                 name: str = "farm", max_retries: int = 2,
                 straggler_timeout_s: float = 60.0, max_respawns: int = 1,
                 aging_every: int = 4, dedup: bool = False):
        boards = list(boards)
        if not boards:
            raise ValueError("a BoardFarm needs at least one board")
        names = [b.name for b in boards]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate board names: {names}")
        self.boards = boards
        self.hw = hw if hw is not None else boards[0].hw
        self.name = name
        self.max_retries = max(0, int(max_retries))
        self.straggler_timeout_s = straggler_timeout_s
        # bypass rounds per +1 effective priority for a jumped candidate
        # (the anti-starvation aging credit)
        self.aging_every = max(1, int(aging_every))
        # collapse same-signature candidates within a submitted batch:
        # measure each distinct signature once, fan the latency out by
        # submission position. Off by default — reusing a measurement for
        # a duplicate is a semantic choice on noisy boards.
        self.dedup = bool(dedup)
        self._respawns_left = {b.name: max(0, int(max_respawns))
                               for b in boards}
        # farm-level counters, cumulative across batches
        self.requeues = 0  # candidate requeue events
        self.preemptions = 0  # dispatches that jumped lower-priority queue
        self.retry_exhausted = 0  # candidates INVALID after max_retries
        self.garbage_sanitized = 0  # non-physical latencies mapped to INVALID
        self.static_rejected = 0  # candidates refused before dispatch
        self.dedup_reused = 0  # candidates settled off a same-signature rep
        self._wall_s = 0.0  # accumulated active span (work in the system)
        self._span_t0: float | None = None  # start of the current active span
        self._tokens = itertools.count()
        self._done: queue.Queue = queue.Queue()  # (token, status, payload)
        # dispatcher state: the shared cross-batch queue + in-flight shards
        self._mu = threading.Lock()
        self._work: deque[_WorkItem] = deque()
        # token -> (board, shard, t0, deadline); shard = [_WorkItem]
        self._inflight: dict[int, tuple[Board, list[_WorkItem], float,
                                        float]] = {}
        self._busy: set[str] = set()
        self._dispatcher: threading.Thread | None = None
        self._closed = False

    # ---- capacity hint ---------------------------------------------------------
    @property
    def max_inflight(self) -> int:
        """Submission-protocol hint: batches that make physical progress
        concurrently — one per board (each board holds one shard)."""
        return len(self.boards)

    # ---- runner protocol -------------------------------------------------------
    def run(self, workload: Workload, schedule: Schedule) -> float:
        return self.run_batch(workload, [schedule])[0]

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        return self.submit_batch(workload, schedules).result()

    # ---- async submission protocol ---------------------------------------------
    def _screen(self, workload: Workload,
                schedules: Sequence[Schedule]) -> set[int]:
        """Indices of schedules the static analyzer proves can never
        validate on this farm's hardware — refused before dispatch so a
        board slot is never burned measuring a provably-INVALID candidate
        (their ticket slots settle to ``INVALID`` immediately)."""
        if not all(getattr(b, "static_screenable", True)
                   for b in self.boards):
            return set()
        report = static_lib.feasibility(workload, self.hw)
        if report is None or not report.exhaustive:
            return set()
        rejected: set[int] = set()
        for i, s in enumerate(schedules):
            try:
                if report.check_schedule(s):
                    rejected.add(i)
            except Exception:
                pass  # unscreenable: let the board (and _sanitize) decide
        return rejected

    def submit_batch(self, workload: Workload,
                     schedules: Sequence[Schedule],
                     priority: int = 0) -> _FarmTicket:
        ticket = _FarmTicket(workload, schedules)
        if not ticket.schedules:
            ticket._complete([])
            return ticket
        # Settle the statically-refused slots before any work item exists:
        # no dispatcher thread can be racing _settle on this ticket yet.
        rejected = self._screen(workload, ticket.schedules)
        if rejected:
            self.static_rejected += len(rejected)
            for idx in sorted(rejected):
                ticket._settle(idx, INVALID)
            if ticket.done():  # everything refused: never touches the farm
                return ticket
        skip = set(rejected)
        if self.dedup:
            # same-signature candidates collapse onto the first (the
            # representative); followers never become work items and settle
            # off whatever the representative's latency turns out to be —
            # the fan-out lives in _FarmTicket._settle, so it survives
            # requeue-from-dead (the representative's _WorkItem keeps the
            # ticket/idx through any number of board deaths).
            first: dict = {}
            for i, s in enumerate(ticket.schedules):
                if i in skip:
                    continue
                r = first.setdefault(s.signature(), i)
                if r != i:
                    ticket.aliases.setdefault(r, []).append(i)
                    skip.add(i)
                    self.dedup_reused += 1
        with self._mu:
            if self._closed:
                ticket._fail(RuntimeError(f"farm {self.name} is closed"))
                return ticket
            if self._span_t0 is None and not self._inflight \
                    and not self._work:
                self._span_t0 = time.monotonic()
            self._work.extend(
                _WorkItem(ticket, i, workload, s, priority=int(priority))
                for i, s in enumerate(ticket.schedules)
                if i not in skip)
            self._ensure_dispatcher()
        self._done.put(_WAKE)
        return ticket

    def _ensure_dispatcher(self) -> None:
        if self._dispatcher is None or not self._dispatcher.is_alive():
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=f"farm-{self.name}-dispatch")
            self._dispatcher.start()

    # ---- dispatch machinery ----------------------------------------------------
    def _board_thread(self, token: int, board: Board,
                      items: list[tuple[Workload, Schedule]]) -> None:
        try:
            lats = board.measure_many(items)
        except BoardDied as e:
            self._done.put((token, "died", str(e)))
        except Exception as e:  # any other escape is a board bug, not fatal
            self._done.put((token, "died", f"{type(e).__name__}: {e}"))
        else:
            self._done.put((token, "ok", lats))

    def _sanitize(self, lat: Any) -> float:
        """Latencies must be physical: strictly positive (or the runner's
        own ``INVALID`` = inf). Garbage (NaN, zero, negatives, non-numbers)
        becomes ``INVALID`` — a bad reading must never poison the cost
        model, and a zero in particular would otherwise be an unbeatable
        fake best that ranks first in the database forever."""
        try:
            lat = float(lat)
        except (TypeError, ValueError):
            lat = float("nan")
        if math.isnan(lat) or lat <= 0:
            self.garbage_sanitized += 1
            return INVALID
        return lat

    def _eff_priority(self, item: _WorkItem) -> int:
        """Submission priority plus the aging credit: every
        ``aging_every`` dispatch rounds a queued candidate is jumped raise
        its effective class by one, bounding starvation under a steady
        high-priority stream."""
        return item.priority + item.bypass // self.aging_every

    def _take_shard_locked(self, n: int) -> list[_WorkItem]:
        """Pop the ``n`` highest-effective-priority queued candidates
        (queue order within a class — with all priorities equal this is
        exactly the old FIFO ``popleft``). Jumped candidates earn a bypass
        credit; dispatches that jump queued work count as preemptions."""
        work = list(self._work)
        order = sorted(range(len(work)),
                       key=lambda i: (-self._eff_priority(work[i]), i))
        taken = sorted(order[:n])  # chosen items, back in queue order
        taken_set = set(taken)
        # the sort key makes any jump a *strict* effective-priority jump:
        # an equal-priority later item can never be taken over an earlier
        # one, so all-default-priority traffic hits neither branch below
        last_taken = taken[-1] if taken else -1
        for pos, item in enumerate(work):
            if pos in taken_set:
                if any(j < pos and j not in taken_set for j in range(pos)):
                    self.preemptions += 1
            elif pos < last_taken:
                item.bypass += 1
        self._work = deque(work[i] for i in range(len(work))
                           if i not in taken_set)
        return [work[i] for i in taken]

    def _dispatch_locked(self) -> None:
        """Hand shards to idle healthy boards from the shared queue in
        effective-priority order; a shard may span batch (ticket)
        boundaries."""
        for board in self.boards:
            if not self._work:
                return
            if not board.healthy or board.name in self._busy:
                continue
            shard = self._take_shard_locked(
                min(board.capacity, len(self._work)))
            token = next(self._tokens)
            board.stats.dispatched += len(shard)
            self._busy.add(board.name)
            now = time.monotonic()
            for item in shard:
                item.ticket._mark_started()
            deadline = now + (board.timeout_s
                              if board.timeout_s is not None
                              else self.straggler_timeout_s)
            self._inflight[token] = (board, shard, now, deadline)
            threading.Thread(
                target=self._board_thread, daemon=True,
                name=f"board-{board.name}",
                args=(token, board,
                      [(item.workload, item.schedule) for item in shard])
            ).start()

    def _requeue_locked(self, board: Board,
                        shard: list[_WorkItem]) -> None:
        for item in shard:
            board.stats.requeued += 1
            if item.attempts + 1 > self.max_retries:
                self.retry_exhausted += 1
                item.ticket._settle(item.idx, INVALID)
            else:
                self.requeues += 1
                item.attempts += 1
                self._work.append(item)

    def _board_down_locked(self, board: Board) -> None:
        board.healthy = False
        board.stats.deaths += 1
        board.abandon()
        if self._respawns_left.get(board.name, 0) > 0:
            self._respawns_left[board.name] -= 1
            if board.respawn():
                board.stats.respawns += 1
                board.healthy = True

    def _fail_pending_locked(self, error: Exception) -> None:
        """Fail every ticket that still has unmeasured candidates (farm
        dead / closed): the measurement queue must fail fast, never block."""
        pending = {item.ticket for item in self._work}
        for _, shard, _, _ in self._inflight.values():
            pending.update(item.ticket for item in shard)
        self._work.clear()
        for ticket in pending:
            if not ticket.done():
                ticket._fail(error)

    def _close_span_locked(self) -> None:
        if self._span_t0 is not None and not self._work \
                and not self._inflight:
            self._wall_s += time.monotonic() - self._span_t0
            self._span_t0 = None

    def _dispatch_loop(self) -> None:
        """Persistent dispatcher: pull completions/deaths off the done
        queue, sweep straggler deadlines, requeue and respawn, keep idle
        boards fed from the shared cross-batch queue."""
        try:
            while True:
                with self._mu:
                    if self._closed:
                        self._fail_pending_locked(
                            RuntimeError(f"farm {self.name} is closed"))
                        return
                    self._dispatch_locked()
                    deadlines = [dl for _, _, _, dl
                                 in self._inflight.values()]
                    idle = not self._work and not self._inflight
                    if idle:
                        self._close_span_locked()
                timeout = None
                if deadlines:
                    timeout = max(0.0, min(deadlines) - time.monotonic())
                elif idle:
                    timeout = self._IDLE_EXIT_S
                try:
                    token, status, payload = self._done.get(timeout=timeout)
                except queue.Empty:
                    token, status, payload = None, None, None
                    if idle:
                        with self._mu:
                            # still nothing to do after the grace: retire
                            # this thread (submit_batch respawns one; a
                            # submit racing us either sees the live thread
                            # and enqueues before we re-check, or sees
                            # None and spawns fresh — never both)
                            if not self._work and not self._inflight \
                                    and not self._closed:
                                if self._dispatcher is \
                                        threading.current_thread():
                                    self._dispatcher = None
                                return
                with self._mu:
                    if status == "stop" or self._closed:
                        self._fail_pending_locked(
                            RuntimeError(f"farm {self.name} is closed"))
                        return
                    if token is not None and token in self._inflight:
                        board, shard, t_disp, _ = self._inflight.pop(token)
                        self._busy.discard(board.name)
                        board.stats.busy_s += time.monotonic() - t_disp
                        if status == "ok" and len(payload) == len(shard):
                            for item, lat in zip(shard, payload):
                                board.stats.completed += 1
                                item.ticket._settle(item.idx,
                                                    self._sanitize(lat))
                        else:  # board died, errored, or broke the protocol
                            self._requeue_locked(board, shard)
                            self._board_down_locked(board)
                    # late messages for abandoned tokens fall through and
                    # are dropped; _WAKE pokes just re-run dispatch
                    now = time.monotonic()
                    for tok in [t for t, (_, _, _, dl)
                                in self._inflight.items() if dl <= now]:
                        board, shard, t_disp, _ = self._inflight.pop(tok)
                        self._busy.discard(board.name)
                        board.stats.busy_s += now - t_disp
                        self._requeue_locked(board, shard)
                        self._board_down_locked(board)
                    self._dispatch_locked()
                    if self._work and not self._inflight \
                            and not any(b.healthy for b in self.boards):
                        self._fail_pending_locked(FarmDead(
                            f"all {len(self.boards)} boards dead with "
                            f"{len(self._work)} candidates unmeasured"))
                    self._close_span_locked()
        except BaseException as e:  # dispatcher bug: never strand waiters
            with self._mu:
                self._fail_pending_locked(
                    e if isinstance(e, Exception)
                    else RuntimeError(f"farm dispatcher died: {e!r}"))
            raise

    # ---- reporting / lifecycle -------------------------------------------------
    def farm_summary(self) -> dict:
        """Per-board utilization and requeue counters (cumulative), the
        payload ``TuneResult.board_stats`` and session summaries carry.
        Utilization is span-accurate: busy seconds over the farm's *active*
        span (the union of periods with work in the system), so concurrent
        batches are not double-counted in the denominator."""
        with self._mu:
            wall = self._wall_s
            if self._span_t0 is not None:
                wall += time.monotonic() - self._span_t0
        return {
            "boards": {b.name: {
                "hw": b.hw.name,
                "healthy": b.healthy,
                "dispatched": b.stats.dispatched,
                "completed": b.stats.completed,
                "requeued": b.stats.requeued,
                "deaths": b.stats.deaths,
                "respawns": b.stats.respawns,
                "busy_s": b.stats.busy_s,
                "utilization": (b.stats.busy_s / wall) if wall > 0 else 0.0,
            } for b in self.boards},
            "requeues": self.requeues,
            "preemptions": self.preemptions,
            "invalid_after_retries": self.retry_exhausted,
            "garbage_sanitized": self.garbage_sanitized,
            "static_rejected": self.static_rejected,
            "dedup_reused": self.dedup_reused,
            "build_cache": build_cache_stats(),
            "measure_wall_s": wall,
        }

    def close(self) -> None:
        with self._mu:
            self._closed = True
            dispatcher = self._dispatcher
        if dispatcher is not None and dispatcher.is_alive():
            self._done.put(_STOP)
            dispatcher.join(timeout=5.0)
        for board in self.boards:
            board.abandon()
            board.close()

    def __enter__(self) -> "BoardFarm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def simulated_farm(n_boards: int, hw: HardwareConfig,
                   delay_s: float | Sequence[float] = 0.0,
                   capacity: int = 1,
                   faults: dict[int, Sequence[Fault]] | None = None,
                   respawns: dict[int, int] | None = None,
                   measure_fn: Callable[[Workload, Schedule], float] | None = None,
                   **farm_kwargs) -> BoardFarm:
    """Farm of ``n_boards`` deterministic simulated boards (benchmarks and
    tests). ``delay_s`` may be one float or a per-board sequence (each
    entry a float or a per-batch latency-script callable); ``faults`` and
    ``respawns`` map board index -> fault script / respawn budget."""
    delays = (list(delay_s) if isinstance(delay_s, (list, tuple))
              else [delay_s] * n_boards)
    if len(delays) != n_boards:
        raise ValueError("delay_s sequence must match n_boards")
    boards = [SimulatedBoard(f"sim{i}", hw, capacity=capacity,
                             delay_s=delays[i],
                             faults=(faults or {}).get(i, ()),
                             respawns=(respawns or {}).get(i, 0),
                             measure_fn=measure_fn)
              for i in range(n_boards)]
    return BoardFarm(boards, **farm_kwargs)
