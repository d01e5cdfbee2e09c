"""The tuning loop — the paper's three-step MetaSchedule cycle.

Per iteration: (1) generate candidates by probabilistic sampling /
evolutionary mutation of schedule traces, (2) build + measure the candidates
*as a batch* on the runner (FPGA/board in the paper; the H100, the CPU
emulation or the analytic model here — see ``Runner.run_batch``), (3) feed
the measured
latencies back into the cost model that ranks the next generation. The best
measured schedule is committed to the database.

A search can be *warm-started* from schedules recorded in a previous run
(same workload, or a near-miss shape/hardware — the paper's Fig. 4 transfer
experiment): they are measured first and seed both the cost model and the
evolutionary population.

Two models learn from every measurement. The cost model ranks candidates
before they are measured; the design-space program's **proposal
distributions** shape where candidates come from: ``_record`` feeds each
measured outcome back into the distributions of the decisions its trace
made (:meth:`SpaceProgram.observe`), with a *rank-relative* reward — the
fraction of previously measured latencies this one beats — so analytic and
real-board runners train the proposals identically and no latency scale
leaks in. ``learn_proposals=False`` restores the pure-uniform sampler;
``prior_distributions`` seeds the program from transferred posteriors
(``TuningDatabase.transfer_distributions``); ``pretrain_cost_model`` folds
a warm database's records into the cost model before the first generation.
The learned posteriors persist to the database from ``finish()``.

Measure/search scheduling
-------------------------
On real hardware, measurement — not search — dominates tuning wall-time
(9-12 s per candidate on the paper's FPGA targets). ``tune`` therefore
supports an asynchronous pipeline (``pipeline_depth > 1``): generation N is
submitted to the measurement backend and generation N+1 is evolved
immediately against the cost model's *predicted* latencies for the
in-flight candidates (a constant-liar strategy), reconciling when the
measurements land.

Submission goes through a :class:`~repro_torch.core.measure_scheduler.
MeasureScheduler`, which holds **multiple batches from multiple drivers in
flight concurrently**: runners with a native async ``submit_batch`` (the
JAX package's board farm; none in the port yet) keep every target busy
across batch — and workload — boundaries, while plain synchronous runners
(``CudaRunner`` among them: one card) are wrapped in the scheduler's
single-FIFO measurement thread.

The pipeline is **deterministic by construction**: each driver's batches
are reconciled in that driver's own submission order (per-driver FIFO), and
a driver's propose/reconcile points depend only on its *own* reconcile
count — so which driver happens to reconcile first (a completion-order
observation under the multi-queue scheduler) can never leak into any
driver's trajectory, and a given seed replays the same per-driver history
regardless of backend shape or runner speed. Runners that measure
instantaneously (the analytic model) declare ``overlap_capable = False``;
for them the effective depth is clamped to 1 — there is no latency to
hide, and the pipelined path then reproduces the synchronous trajectory
bit-identically.

The mechanics live in :class:`TuneDriver`, an explicit propose/reconcile
state machine; :class:`~repro_torch.core.session.TuningSession` drives several
drivers against one scheduler to interleave one workload's measurement with
another's evolution. Overlap accounting is span-accurate: the scheduler
records real measuring/waiting intervals, not summed totals.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Mapping, Sequence

from repro_torch.core import space as space_lib
from repro_torch.core.build_cache import build_cache_stats, stats_delta
from repro_torch.core.cost_model import (RidgeCostModel, features,
                                   pretrain_from_database)
from repro_torch.core.database import TuningDatabase
from repro_torch.core.evolution import EvolutionarySearch
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.measure_scheduler import MeasureScheduler
from repro_torch.core.runner import INVALID, Runner, run_batch as _run_batch
from repro_torch.core.sampler import TraceSampler
from repro_torch.core import static_analysis as static_lib
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class TuneResult:
    workload: Workload
    hw: HardwareConfig
    best_schedule: Schedule | None
    best_latency: float
    history: list[tuple[Schedule, float]]
    trials: int
    wall_time_s: float
    warm_started: int = 0  # warm-start candidates actually measured
    pipeline_depth: int = 1  # effective depth the search ran at
    measure_time_s: float = 0.0  # total time the runner spent measuring
    overlap_s: float = 0.0  # measurement time hidden behind search work
    # per-board utilization / requeue counters when the runner is a board
    # farm (see board_farm.BoardFarm.farm_summary); None for single-target
    # runners
    board_stats: dict | None = None
    # normalized posterior entropy per decision at the end of the search
    # (1.0 = still uniform, -> 0 = proposal converged); {} when proposal
    # learning was disabled
    proposal_entropy: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # candidate values the static analyzer filtered out of proposal
    # (core/static_analysis.py). 0 certifies the search consumed a rng
    # stream bit-identical to the pre-analyzer sampler: candidate sets with
    # nothing to prune are passed through as the original tuple objects.
    static_pruned: int = 0
    # (submitted-count, effective depth) breakpoints: the speculation depth
    # this search actually ran at over time. A fixed-depth run has one
    # entry; an adaptive run shows every grow/shrink the depth policy made.
    depth_trace: list = dataclasses.field(default_factory=list)
    # the session's stop policy curtailed this search before its budget ran
    # out (proposals converged and the best latency plateaued)
    stopped_early: bool = False
    # extra trials granted from other drivers' released budget
    budget_granted: int = 0
    # process-wide build-cache counter deltas over this driver's lifetime
    # (hits/misses/evictions — overlapping when drivers interleave, since
    # the cache is shared); None when the runner never builds (analytic)
    # is *not* distinguished — the delta is simply zero then
    build_cache: dict | None = None
    # trials settled from the database's cross-session measured-latency
    # memo instead of being re-measured (reuse_measured=True only)
    measured_memo: int = 0

    @property
    def mean_proposal_entropy(self) -> float:
        """Mean normalized proposal entropy across this search's decisions
        (NaN when learning was off) — the per-session convergence trend the
        benchmark report tracks."""
        if not self.proposal_entropy:
            return float("nan")
        vals = list(self.proposal_entropy.values())
        return sum(vals) / len(vals)

    @property
    def overlap_fraction(self) -> float:
        """Fraction of measurement time overlapped with search (0 = fully
        synchronous, toward 1 = measurement fully hidden)."""
        if self.measure_time_s <= 0:
            return 0.0
        return self.overlap_s / self.measure_time_s

    @property
    def best_params(self):
        if self.best_schedule is None:
            return None
        return space_lib.concretize(self.workload, self.hw, self.best_schedule)


def effective_pipeline_depth(runner: Runner, requested: int) -> int:
    """Clamp the pipeline depth to what the runner can actually use.

    A runner that measures instantaneously and deterministically (e.g. the
    analytic model) gains nothing from speculating against predicted
    latencies — it only degrades search quality — so unless it declares
    ``overlap_capable = True`` the depth is clamped to 1, which keeps the
    pipelined execution bit-identical to the synchronous trajectory.

    An overlap-capable runner that also declares a ``max_inflight``
    capacity hint (the serial measurement queue and ``MeasurePool``-backed
    runners report 1; a board farm its board count) is clamped to
    ``max_inflight + 1`` — one batch per concurrently-progressing slot plus
    one being evolved against the constant liar. Depth beyond that only
    parks batches in the backend's queue, deepening speculation on stale
    predictions with zero extra overlap; the clamp happens once, here, and
    the depth actually used is what ``TuneResult.pipeline_depth`` reports.
    Runners without the hint keep the requested depth.
    """
    if requested <= 1:
        return 1
    if not getattr(runner, "overlap_capable", False):
        return 1
    hint = getattr(runner, "max_inflight", None)
    if hint is None:
        return requested
    return min(requested, max(1, int(hint)) + 1)


class TuneDriver:
    """Single-workload tuning as an explicit propose/reconcile state machine.

    The synchronous loop is ``while (b := driver.propose()) is not None:
    driver.reconcile(b, run_batch(runner, workload, b))``. A pipelined
    executor may hold several proposed batches in flight; ``propose`` then
    speculates using the cost model's predicted latencies for the in-flight
    candidates and ``reconcile`` must be called in submission order (history
    order is the database's replay order and stays deterministic).

    ``propose() is None`` means "no further batch given current knowledge":
    final only once nothing is in flight — with batches outstanding the
    caller should reconcile and ask again.
    """

    def __init__(self, workload: Workload, hw: HardwareConfig, runner: Runner,
                 trials: int = 64, seed: int = 0,
                 database: TuningDatabase | None = None,
                 warmup_fraction: float = 0.25, batch: int = 4,
                 warm_start: Sequence[Schedule] = (),
                 log: Callable[[str], None] | None = None,
                 learn_proposals: bool = True,
                 prior_distributions: Mapping[str, Mapping] | None = None,
                 pretrain_cost_model: bool = False,
                 static_analysis: bool = True,
                 priority: int = 0,
                 reuse_measured: bool = False):
        self.workload, self.hw, self.runner = workload, hw, runner
        self.trials = trials
        self.batch = batch
        self.database = database
        self.log = log
        # scheduling priority class: run_scheduled forwards it with every
        # submit, so this driver's batches preempt lower-priority backlog
        # on priority-aware backends (results are unaffected — see
        # measure_scheduler module docstring)
        self.priority = int(priority)
        # wall-time span of this driver's own activity: first propose() to
        # last reconcile() — in an interleaved session drivers are all
        # constructed up front, so stamping construction time here would
        # over-attribute the session's setup (and any other driver's head
        # start) to every driver. Set only by the first propose().
        self.t_start: float | None = None
        self._t_last: float | None = None
        self._started = False
        # the generative design-space program (variant-conditioned tile
        # splits, postprocessor pipeline) this search samples and replays
        self.space = space_lib.space_for(workload, hw)
        # Static feasibility: intersect every candidate set with the values
        # provably able to complete into a postprocessor-valid schedule, so
        # statically-dead candidates are never proposed. The wrapped program
        # shares the original's instruction dists (proposal learning and
        # persistence see the same state); static_pruned counts the values
        # actually filtered at sampling time — 0 means every candidate set
        # was passed through untouched and the rng stream is bit-identical
        # to running with static_analysis=False.
        self.static_pruned = 0
        self.static_report = (static_lib.feasibility(workload, hw)
                              if static_analysis else None)
        if self.static_report is not None:
            self.space = static_lib.pruned_program(
                self.space, self.static_report, self._count_pruned)
        self.learn_proposals = learn_proposals
        if learn_proposals and prior_distributions:
            # transferred posteriors warm-start the proposals (Fig. 4 on
            # distributions); with learning off, priors would silently bias
            # a sampler the caller asked to be uniform, so they're ignored
            self.space.seed_priors(prior_distributions)
        # sorted finite latencies measured so far — the reference population
        # for the rank-relative proposal reward
        self._lat_sorted: list[float] = []
        self.sampler = TraceSampler(seed)
        self.cost_model = RidgeCostModel()
        if pretrain_cost_model and database is not None:
            pretrain_from_database(self.cost_model, database, hw)
        self.search = EvolutionarySearch(workload, hw, self.space,
                                         self.sampler)
        self.measured: dict[tuple, float] = {}
        self.history: list[tuple[Schedule, float]] = []
        self.best_schedule: Schedule | None = None
        self.best_latency = INVALID
        self.warm_started = 0
        # consecutive measurements since the last best-latency improvement
        # — the plateau signal the session's entropy stop policy reads
        self.plateau_len = 0
        # (submitted-count, depth) breakpoints -> TuneResult.depth_trace
        self.depth_trace: list[tuple[int, int]] = []
        self.stopped_early = False  # curtailed by a session stop policy
        self.budget_granted = 0  # trials granted from released budget
        # Cross-session re-measure memo (off by default — reusing a stored
        # latency changes which candidates get fresh measurements): _take
        # settles candidates the database already measured at equal
        # fidelity (same runner name) straight into the history, spending
        # a trial but never a board slot. Within-session duplicates never
        # reach the memo — _take's own signature dedup catches them first.
        self.reuse_measured = bool(reuse_measured) and database is not None
        self.measured_memo = 0  # trials settled from the database memo
        # process-wide build-cache snapshot; finish() reports the delta
        self._build_cache_before = build_cache_stats()
        # pipeline bookkeeping (written by the scheduler loop below)
        self.measure_time_s = 0.0  # runner time across this driver's batches
        self.wait_time_s = 0.0  # main-thread time blocked on this driver
        # span-accurate overlap, set by run_scheduled (None -> finish()
        # falls back to the summed-totals estimate of the sync path)
        self.overlap_span_s: float | None = None
        # Seeds take at most half the budget so even floor-budget workloads
        # always perform some fresh search instead of only replaying records.
        # Schedules from foreign spaces may not concretize here; skipped free.
        self._warm = [s for s in warm_start
                      if space_lib.concretize(workload, hw, s).valid]
        self._warm = self._warm[: trials // 2]
        self._in_flight: deque[Schedule] = deque()
        self._in_flight_sigs: set[tuple] = set()
        self._submitted = 0  # == len(history) + len(_in_flight)
        self._n_warmup = max(4, int(trials * warmup_fraction))
        self._tries = 0  # phase-1 sampling attempts (bounded)
        self._phase = 0
        self._population_seeded = False

    def _count_pruned(self, n: int) -> None:
        """Prune-event sink for the statically-filtered program wrapper."""
        self.static_pruned += n

    # ---- proposal --------------------------------------------------------------
    def _take(self, schedules: Sequence[Schedule]) -> list[Schedule]:
        """Drop already-measured / in-flight / within-batch duplicate
        candidates, settle any the database memo already holds at equal
        fidelity (``reuse_measured``), mark the rest in flight, and return
        them."""
        todo: list[Schedule] = []
        seen: set[tuple] = set()
        for s in schedules:
            sig = s.signature()
            if sig in self.measured or sig in self._in_flight_sigs \
                    or sig in seen:
                continue
            if self.reuse_measured:
                lat = self.database.measured_latency(
                    self.workload, self.hw.name, s,
                    runner_name=self.runner.name)
                if lat is not None:
                    # a prior session measured this exact concretization on
                    # a runner of the same name: spend the trial, record
                    # the stored latency, never occupy a measurement slot
                    self.measured_memo += 1
                    self._submitted += 1
                    self._record(s, lat)
                    continue
            seen.add(sig)
            todo.append(s)
        for s in todo:
            self._in_flight.append(s)
            self._in_flight_sigs.add(s.signature())
        self._submitted += len(todo)
        return todo

    def _elites(self) -> list[Schedule]:
        """Top-4 schedules by latency — measured, plus (when speculating)
        in-flight candidates at their predicted latency. An unfitted model
        predicts exp(0) = 1 s, which keeps speculative candidates out of the
        elite set until there is evidence for them."""
        ranked = list(self.history)
        for s in self._in_flight:
            params = space_lib.concretize(self.workload, self.hw, s)
            if params.valid:
                # predict() is log-latency; cap before exp so a wild early
                # extrapolation can't overflow (it only needs to rank)
                pred = math.exp(min(self.cost_model.predict(
                    features(self.workload, self.hw, params)), 700.0))
            else:
                pred = INVALID
            ranked.append((s, pred))
        return [s for s, l in sorted(ranked, key=lambda r: r[1])[:4]
                if l != INVALID]

    def propose(self) -> list[Schedule] | None:
        if not self._started:
            self._started = True
            self.t_start = time.perf_counter()
        # Phase 0 — warm start from prior records (database transfer).
        if self._phase == 0:
            self._phase = 1
            todo = self._take(self._warm)
            if todo:
                self.warm_started = len(todo)
                return todo
        # Phase 1 — probabilistic sampling warm-up.
        if self._phase == 1:
            target = min(self._n_warmup, self.trials)
            while self._submitted < target and self._tries < 50 * self.trials:
                pending: list[Schedule] = []
                want = min(self.batch, target - self._submitted)
                while len(pending) < want and self._tries < 50 * self.trials:
                    self._tries += 1
                    s = self.sampler.sample(self.space)
                    if space_lib.concretize(self.workload, self.hw, s).valid:
                        pending.append(s)
                todo = self._take(pending)
                if todo:
                    return todo
            self._phase = 2
        # Phase 2 — evolutionary search guided by the cost model.
        if not self._population_seeded:
            self.search.seed_population(
                [s for s, _ in self.history] + list(self._in_flight))
            self._population_seeded = True
        while self._submitted < self.trials:
            self.search.evolve(self.cost_model, self._elites())
            proposals = self.search.propose(
                min(self.batch, self.trials - self._submitted),
                exclude=set(self.measured) | self._in_flight_sigs)
            before = self._submitted
            todo = self._take(proposals)
            if todo:
                return todo
            if self._submitted == before:
                # nothing taken and nothing memo-settled: the search has no
                # fresh candidates to offer (a memo-settled round spends
                # budget without producing a batch — keep evolving)
                return None
        return None

    # ---- reconciliation --------------------------------------------------------
    def reconcile(self, schedules: Sequence[Schedule],
                  latencies: Sequence[float]) -> None:
        """Fold one measured batch back in. Batches must arrive in the order
        they were proposed (FIFO) so history replays deterministically."""
        for s, latency in zip(schedules, latencies):
            head = self._in_flight.popleft()
            if head.signature() != s.signature():
                raise RuntimeError("reconcile out of submission order")
            self._in_flight_sigs.discard(s.signature())
            self._record(s, latency)
        self._t_last = time.perf_counter()

    def _record(self, s: Schedule, latency: float) -> None:
        self.measured[s.signature()] = latency
        self.history.append((s, latency))
        self.plateau_len = 0 if latency < self.best_latency \
            else self.plateau_len + 1
        params = space_lib.concretize(self.workload, self.hw, s)
        if params.valid and math.isfinite(latency):
            self.cost_model.update(features(self.workload, self.hw, params),
                                   latency)
            if self.learn_proposals:
                # rank-relative reward: the fraction of previously measured
                # latencies this one beats (midpoint-corrected so the first
                # measurement is neutral at 0.5) — scale-free, so analytic
                # and real-board runners train the proposals identically,
                # and deterministic given reconcile order
                worse = len(self._lat_sorted) - bisect.bisect_right(
                    self._lat_sorted, latency)
                reward = (worse + 0.5) / (len(self._lat_sorted) + 1)
                self.space.observe(s, reward)
                bisect.insort(self._lat_sorted, latency)
            if self.database is not None:
                self.database.add(self.workload, self.hw.name, s, latency,
                                  self.runner.name)
            if latency < self.best_latency:
                self.best_schedule, self.best_latency = s, latency
                if self.log:
                    self.log(f"  trial {len(self.history):3d}: "
                             f"{latency*1e6:10.1f} us  "
                             f"<- new best {s.as_dict()}")

    # ---- adaptation hooks (depth trace, budget reallocation) -------------------
    def note_depth(self, depth: int) -> None:
        """Record the effective speculation depth this driver is being run
        at; called by the executor on every change (and once at start), so
        ``TuneResult.depth_trace`` shows the depth over the search."""
        if not self.depth_trace or self.depth_trace[-1][1] != depth:
            self.depth_trace.append((self._submitted, depth))

    @property
    def remaining_trials(self) -> int:
        """Trials not yet submitted (what a stop policy could release)."""
        return max(0, self.trials - self._submitted)

    def proposal_entropy_now(self) -> dict[str, float]:
        """Current per-decision normalized proposal entropy ({} with
        learning off) — the live convergence signal stop policies read,
        as opposed to the end-of-search snapshot ``finish()`` reports."""
        return self.space.proposal_entropy() if self.learn_proposals else {}

    def curtail(self) -> int:
        """Stop proposing new batches: cap the budget at what has already
        been submitted (in-flight batches still reconcile normally) and
        return the number of trials released for reallocation."""
        released = self.remaining_trials
        if released:
            self.trials = self._submitted
        self.stopped_early = True
        return released

    def extend_budget(self, extra: int) -> None:
        """Grant this driver ``extra`` more trials (reallocated from a
        curtailed driver's released budget)."""
        if extra > 0:
            self.trials += int(extra)
            self.budget_granted += int(extra)

    # ---- completion ------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self._in_flight

    def finish(self, pipeline_depth: int = 1) -> TuneResult:
        if self._in_flight:
            raise RuntimeError("finish() with batches still in flight")
        summary = getattr(self.runner, "farm_summary", None)
        # authoritative wall-time span: first propose() -> last reconcile()
        # (zero if the driver never ran — construction time is not activity)
        if self.t_start is None or self._t_last is None:
            wall = 0.0
        else:
            wall = self._t_last - self.t_start
        if self.overlap_span_s is not None:
            overlap = self.overlap_span_s  # span-accurate (scheduler)
        else:
            overlap = max(0.0, self.measure_time_s - self.wait_time_s)
        entropy: dict[str, float] = {}
        if self.learn_proposals:
            entropy = self.space.proposal_entropy()
            if self.database is not None:
                self.database.set_distributions(
                    self.workload, self.hw.name, self.space.dists_to_json())
        return TuneResult(
            self.workload, self.hw, self.best_schedule, self.best_latency,
            self.history, len(self.history), wall,
            warm_started=self.warm_started, pipeline_depth=pipeline_depth,
            measure_time_s=self.measure_time_s, overlap_s=overlap,
            board_stats=summary() if callable(summary) else None,
            proposal_entropy=entropy, static_pruned=self.static_pruned,
            depth_trace=list(self.depth_trace),
            stopped_early=self.stopped_early,
            budget_granted=self.budget_granted,
            build_cache=stats_delta(build_cache_stats(),
                                    self._build_cache_before),
            measured_memo=self.measured_memo)


def timed_run_batch(runner: Runner, driver: TuneDriver,
                    schedules: Sequence[Schedule]) -> list[float]:
    """Measure one batch synchronously, charging its runner time to the
    driver (the depth-1 path of ``tune``)."""
    t0 = time.perf_counter()
    try:
        return _run_batch(runner, driver.workload, schedules)
    finally:
        driver.measure_time_s += time.perf_counter() - t0


def run_scheduled(drivers: Sequence[TuneDriver], runner: Runner,
                  depth: int, multi_queue: bool | None = None,
                  scheduler: MeasureScheduler | None = None,
                  depth_policy=None,
                  on_reconcile: Callable[[int, TuneDriver], None] | None = None
                  ) -> MeasureScheduler:
    """Drive one or many :class:`TuneDriver` state machines against a
    :class:`~repro_torch.core.measure_scheduler.MeasureScheduler`.

    Every driver is topped up to its effective depth in-flight batches
    (fixed round-robin fill order), then the next reconcilable batch is
    collected: per-driver FIFO always, highest-priority then
    earliest-completed first across drivers — so on a multi-queue backend
    (a board farm) a driver whose batch finished early is refilled
    immediately instead of queueing behind another driver's slower batch,
    and the backend never starves while any driver has work. A driver's
    propose/reconcile points depend only on its own reconcile count, so
    per-driver histories are bit-identical to the single-FIFO schedule for
    a fixed seed (see the module docstring).

    ``depth_policy`` (an
    :class:`~repro_torch.core.measure_scheduler.AdaptiveDepthPolicy`, default
    None = fixed ``depth`` everywhere, bit-identical to the pre-adaptive
    executor) supplies each driver's effective depth before every top-up
    and is fed each reconcile's lag afterwards. ``on_reconcile`` (the
    session's entropy stop policy) runs after every reconcile with the
    driver — it may curtail the driver or extend its budget; both only
    change how many batches ``propose()`` will still yield, never the
    content of batches already proposed. It also runs for any drained
    driver whose own budget is spent, before each top-up pass, so budget
    released by other drivers can still reach a driver that exhausted its
    own *before* the release happened.

    Returns the scheduler (already closed) so callers can read its
    span-accurate measure/wait/overlap accounting; each driver's
    ``overlap_span_s`` is stamped from it before returning. Callers that
    need the scheduler's effective mode up front (its ``multi_queue``
    attribute is the authority on whether the native path is in use) may
    construct it themselves and pass it as ``scheduler``.
    """
    if scheduler is None:
        scheduler = MeasureScheduler(runner, multi_queue=multi_queue)
    counts = [0] * len(drivers)
    try:
        while True:
            submitted = False
            for i, driver in enumerate(drivers):
                target = depth_policy.depth(i) if depth_policy is not None \
                    else depth
                driver.note_depth(target)
                if (on_reconcile is not None and counts[i] == 0
                        and driver.remaining_trials <= 0):
                    # drained with its own budget spent: the hook gets a
                    # chance to extend it from budget other drivers released
                    # *after* this driver's last reconcile. Fully drained,
                    # so any granted batch is proposed with complete
                    # knowledge of the driver's own history — at depth 1 an
                    # extended history is exactly the unextended history
                    # plus extra trailing batches.
                    on_reconcile(i, driver)
                while counts[i] < target:
                    batch = driver.propose()
                    if batch is None:
                        break
                    scheduler.submit(i, driver.workload, batch,
                                     priority=getattr(driver, "priority", 0))
                    counts[i] += 1
                    submitted = True
            if scheduler.inflight():
                i, batch, latencies, wait_s, measure_s = \
                    scheduler.collect_next()
                drivers[i].wait_time_s += wait_s
                drivers[i].measure_time_s += measure_s
                drivers[i].reconcile(batch, latencies)
                counts[i] -= 1
                if depth_policy is not None:
                    # lag: this driver's batches still in flight when the
                    # collected one reconciled (all proposed against the
                    # constant liar rather than its real latencies)
                    depth_policy.on_collect(i, scheduler, counts[i])
                if on_reconcile is not None:
                    on_reconcile(i, drivers[i])
            elif not submitted:
                break
    finally:
        scheduler.close()
        for i, driver in enumerate(drivers):
            driver.overlap_span_s = scheduler.overlap_s(i)
    return scheduler


def run_pipelined(drivers: Sequence[TuneDriver], runner: Runner,
                  depth: int) -> None:
    """Single-FIFO compatibility wrapper over :func:`run_scheduled`
    (``multi_queue=False``): all drivers feed one measurement thread, the
    pre-scheduler behaviour benchmarks compare against."""
    run_scheduled(drivers, runner, depth, multi_queue=False)


def tune(workload: Workload, hw: HardwareConfig, runner: Runner,
         trials: int = 64, seed: int = 0,
         database: TuningDatabase | None = None,
         warmup_fraction: float = 0.25,
         batch: int = 4,
         warm_start: Sequence[Schedule] = (),
         log: Callable[[str], None] | None = None,
         pipeline_depth: int = 1,
         learn_proposals: bool = True,
         prior_distributions: Mapping[str, Mapping] | None = None,
         pretrain_cost_model: bool = False,
         static_analysis: bool = True,
         adaptive_depth: bool = False,
         max_depth: int = 8,
         priority: int = 0,
         reuse_measured: bool = False) -> TuneResult:
    """Tune one workload. ``pipeline_depth`` bounds how many proposed batches
    may be in flight at once (1 = fully synchronous; see module docstring for
    the determinism guarantees of the pipelined mode); ``adaptive_depth``
    lets an :class:`~repro_torch.core.measure_scheduler.AdaptiveDepthPolicy` grow
    the effective depth up to ``max_depth`` where the backend would
    otherwise idle (off by default: fixed-seed histories then stay
    bit-identical to the fixed-depth executor); ``priority`` tags this
    search's batches for priority-aware backends; ``reuse_measured`` (off
    by default) settles candidates the database already measured at equal
    fidelity from the stored latency instead of re-measuring them
    (``TuneResult.measured_memo`` counts them); the ``learn_*`` /
    ``prior_distributions`` / ``pretrain_cost_model`` knobs are documented
    on :class:`TuneDriver`."""
    driver = TuneDriver(workload, hw, runner, trials=trials, seed=seed,
                        database=database, warmup_fraction=warmup_fraction,
                        batch=batch, warm_start=warm_start, log=log,
                        learn_proposals=learn_proposals,
                        prior_distributions=prior_distributions,
                        pretrain_cost_model=pretrain_cost_model,
                        static_analysis=static_analysis,
                        priority=priority,
                        reuse_measured=reuse_measured)
    depth = effective_pipeline_depth(runner, pipeline_depth)
    if pipeline_depth <= 1:
        while (batch_s := driver.propose()) is not None:
            latencies = timed_run_batch(runner, driver, batch_s)
            driver.reconcile(batch_s, latencies)
        driver.wait_time_s = driver.measure_time_s  # nothing overlapped
        driver.overlap_span_s = 0.0
        driver.note_depth(1)
    else:
        # Even when clamped to depth 1, run through the scheduler so the
        # asynchronous plumbing is exercised (and verified bit-identical).
        from repro_torch.core.measure_scheduler import AdaptiveDepthPolicy

        policy = AdaptiveDepthPolicy(depth, max_depth=max_depth) \
            if adaptive_depth and depth > 1 else None
        run_scheduled([driver], runner, depth, depth_policy=policy)
        if depth == 1:
            # at depth 1 nothing can overlap; don't let scheduling jitter
            # between submit and collect report as spurious overlap
            driver.wait_time_s = driver.measure_time_s
            driver.overlap_span_s = 0.0
    if database is not None and database.path:
        database.save()
    return driver.finish(pipeline_depth=depth)
