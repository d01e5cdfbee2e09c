"""Multi-workload tuning sessions — whole-network tuning as one unit (the
JAX package's ``core/session.py``, ported).

The paper tunes per extracted task and then deploys the whole network through
the database. A :class:`TuningSession` does that for a model config
(``[(count, Workload), ...]``, the format of :mod:`repro_torch.nets` and of
``runtime.serve_loop.decode_ops``):

- **dedup** — the config is collapsed to its unique workloads via
  ``workload.key()``; repeated layers tune once and share the result;
- **warm start** — each search is seeded with the best near-miss records
  already in the :class:`TuningDatabase` (same key from a prior session, or
  the same op family at a neighbouring shape/hardware — Fig. 4 transfer),
  *and* with the blended proposal posteriors those prior searches learned
  (``transfer_distributions`` -> ``SpaceProgram.seed_priors``);
- **shared budget** — a single trial budget is split across the unique
  workloads, weighted by their contribution to model latency
  (``count * flops``), with a per-workload floor;
- **overlap** — on runners with real measurement latency
  (``overlap_capable``: ``CudaRunner``, ``EmulateRunner``) the session
  drives all workloads' :class:`~repro_torch.core.tuner.TuneDriver` state
  machines through one
  :class:`~repro_torch.core.measure_scheduler.MeasureScheduler`, so one
  workload's candidates are evolved on the host while another's batch is
  timed on the card by the scheduler's measurement thread.
  ``pipeline_depth`` additionally lets a single driver keep several
  batches in flight (speculative evolution against predicted latencies —
  see ``tuner.py``). Interleaving stays deterministic — each driver
  reconciles its own batches in submission order and its propose points
  depend only on its own reconcile count — but trades away
  *within-session* warm-start chaining: every workload's transfer seeds
  are drawn from the database as it stood when the session began.
  Instantaneous runners (the analytic model) keep the serial path and its
  chaining.
- **adaptation** (all off by default, so fixed-seed histories stay
  bit-identical to the non-adaptive session) — ``adaptive_depth=True``
  hands the interleaved executor an
  :class:`~repro_torch.core.measure_scheduler.AdaptiveDepthPolicy`, which
  grows each driver's speculation depth while the backend's busy-fraction
  sits below ``target_utilization`` and shrinks it when reconciliation lag
  exceeds its threshold. ``stop_policy="entropy"`` curtails searches whose
  proposals have converged and reallocates ``reallocate_fraction`` of the
  released trials to still-improving drivers through one shared
  :class:`BudgetLedger`. ``priority`` tags every batch of the session for
  priority-aware backends. The depth policy reads only the scheduler's
  recorded span intervals, never wall-clock (``tools/lint_invariants.py``
  enforces this).
- **reporting** — per-workload progress lines plus a session-level
  latency/speedup summary committed to the database. Measure/search
  overlap and the measurement span are *span-accurate*: the scheduler
  records real busy/wait intervals. Fixed-library baselines are measured
  as one scheduled wave — every workload's baseline in flight together.

Sessions are also the engine of **traffic-driven continuous tuning**
(``core/traffic.py``): a :class:`~repro_torch.core.traffic.ContinuousTuner`
hands each cycle's traffic-log entries to :meth:`TuningSession.tune_model`
with their hit counts as multiplicities.

On a :class:`~repro_torch.core.board_farm.BoardFarm` the summary carries
the farm's per-board counters (``board_stats``: dispatched, completed,
requeued, deaths, respawns, utilization) and its ``preemptions``; on a
single-target runner they are ``None`` / 0.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

from repro_torch import tracing
from repro_torch.core import tuner
from repro_torch.core.build_cache import build_cache_stats, stats_delta
from repro_torch.core.database import TuningDatabase
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.measure_scheduler import MeasureScheduler
from repro_torch.core.runner import Runner
from repro_torch.core.schedule import Schedule
from repro_torch.core.tuner import TuneResult
from repro_torch.core.workload import Workload

ModelConfig = Sequence[tuple[int, Workload]]


@dataclasses.dataclass
class BudgetLedger:
    """Trial budget released by curtailed drivers, available for grants.

    One ledger is shared across an interleaved session: when the stop
    policy curtails a converged driver, its unspent trials are released
    here; a still-improving driver that exhausts its own budget draws
    grants from the balance. ``reallocate_fraction`` caps how much of the
    released budget may be re-granted (1.0 = all of it; 0.0 = early stop
    saves every released trial outright, nothing is reallocated).
    """

    reallocate_fraction: float = 1.0
    released: int = 0  # trials returned by curtailed drivers
    granted: int = 0  # trials re-granted to still-improving drivers

    def release(self, n: int) -> None:
        self.released += max(0, int(n))

    @property
    def available(self) -> int:
        cap = int(self.released * self.reallocate_fraction)
        return max(0, cap - self.granted)

    def draw(self, n: int) -> int:
        """Grant up to ``n`` trials from the balance; returns the grant."""
        got = min(max(0, int(n)), self.available)
        self.granted += got
        return got


class EntropyStopPolicy:
    """Curtail converged searches, re-grant their budget to improving ones.

    Installed as ``run_scheduled``'s ``on_reconcile`` hook, so it fires at
    each driver's own reconcile points and reads only that driver's own
    deterministic state (its live proposal entropies and best-latency
    plateau length) — decisions therefore replay bit-identically for a
    fixed seed regardless of completion order, and a curtailed workload's
    history is a deterministic prefix of its uncurtailed history.

    A driver is **converged** — curtailed, its remaining budget released to
    the shared :class:`BudgetLedger` — when its mean normalized proposal
    entropy is at most ``entropy_threshold``, no single decision's entropy
    exceeds ``max_decision_entropy``, and its best latency has not improved
    for ``plateau_patience`` consecutive measurements. Calibration note:
    the proposals are posterior-mean-reward weights
    (``space.DecisionDistribution``), deliberately soft, so their
    normalized entropy sits close to 1.0 even late in a search — the
    default threshold (0.995) therefore reads as "measurably below
    uniform", the plateau is the workhorse signal, and the entropy gate's
    job is to keep plateaus that happen *before the proposals have learned
    anything* (uniform posteriors, e.g. a tiny budget) from stopping the
    search. ``max_decision_entropy`` defaults to 1.0 (off): decisions late
    in the mode prefix legitimately carry no evidence and sit at exactly
    1.0, so tighten it only for flat (non-chained) spaces where "one
    still-undecided axis" is meaningful. A driver that exhausts
    its own budget while still **exploring** (plateau shorter than the
    patience) draws one batch worth of trials per reconcile from the
    ledger; since converged drivers never draw, released budget flows to
    the highest-entropy still-improving searches. Requires proposal
    learning — with it off the entropy signal is empty and the policy
    never fires.
    """

    def __init__(self, ledger: BudgetLedger,
                 entropy_threshold: float = 0.995,
                 plateau_patience: int = 12,
                 max_decision_entropy: float = 1.0,
                 log: Callable[[str], None] | None = None):
        self.ledger = ledger
        self.entropy_threshold = float(entropy_threshold)
        self.plateau_patience = max(1, int(plateau_patience))
        self.max_decision_entropy = float(max_decision_entropy)
        self.log = log
        self.stops = 0  # drivers curtailed

    def __call__(self, key, driver) -> None:
        if driver.stopped_early:
            return  # curtailed drivers stay stopped (and never draw)
        if driver.remaining_trials <= 0:
            # own budget exhausted: still-improving searches draw a grant
            if driver.plateau_len < self.plateau_patience:
                got = self.ledger.draw(driver.batch)
                if got:
                    driver.extend_budget(got)
                    if self.log:
                        self.log(f"  budget: +{got} trials -> "
                                 f"{driver.workload.key()} (still improving)")
            return
        entropy = driver.proposal_entropy_now()
        if not entropy:
            return  # proposal learning off: no convergence signal
        vals = list(entropy.values())
        if (sum(vals) / len(vals) <= self.entropy_threshold
                and max(vals) <= self.max_decision_entropy
                and driver.plateau_len >= self.plateau_patience):
            released = driver.curtail()
            self.ledger.release(released)
            self.stops += 1
            if self.log:
                self.log(f"  budget: stopped {driver.workload.key()} "
                         f"(converged), released {released} trials")


@dataclasses.dataclass
class WorkloadReport:
    """Per-unique-workload outcome within a session."""

    workload: Workload
    count: int  # occurrences in the model (dedup multiplicity)
    trials: int
    best_latency: float
    best_schedule: Schedule | None
    warm_started: int  # database warm-start candidates measured
    fixed_latency: float  # hand-written library baseline on this runner
    wall_time_s: float
    # mean normalized proposal entropy at search end (1.0 = uniform,
    # -> 0 = converged; NaN when proposal learning was off)
    proposal_entropy: float = float("nan")
    # the entropy stop policy curtailed this search before its budget ran
    # out / trials it was granted from other searches' released budget
    stopped_early: bool = False
    budget_granted: int = 0

    @property
    def total_latency(self) -> float:
        return self.count * self.best_latency

    @property
    def speedup_vs_fixed(self) -> float:
        if not (self.fixed_latency > 0 and self.best_latency > 0):
            return float("nan")
        return self.fixed_latency / self.best_latency


@dataclasses.dataclass
class SessionResult:
    hw: HardwareConfig
    runner_name: str
    reports: list[WorkloadReport]
    total_trials: int
    wall_time_s: float
    interleaved: bool = False
    pipeline_depth: int = 1
    measure_time_s: float = 0.0  # summed runner time across all batches
    overlap_s: float = 0.0  # measurement time hidden behind search
    # summed host time the drivers spent proposing and reconciling
    search_time_s: float = 0.0
    # span-accurate measurement wall-clock: union of the real measuring
    # intervals (concurrent batches not double-counted); 0 when unknown
    measure_span_s: float = 0.0
    multi_queue: bool = False  # batches from many drivers in flight at once
    model: str = ""  # model/config name, for cross-session trend reports
    # per-board counters of a runner with ``farm_summary`` (a board farm);
    # None for single-target runners
    board_stats: dict | None = None
    # ---- adaptation observability ----
    adaptive_depth: bool = False  # depth policy was active
    stop_policy: str = "none"  # budget policy the session ran under
    stopped_early: int = 0  # drivers curtailed by the stop policy
    released_trials: int = 0  # trials returned by curtailed drivers
    reallocated_trials: int = 0  # released trials re-granted to others
    preemptions: int = 0  # dispatches that jumped lower-priority work
    # process-wide build-cache counter deltas over this session (see
    # core/build_cache.py); None when never snapshotted (old payloads)
    build_cache: dict | None = None
    # trials settled from the database's cross-session measured-latency
    # memo across all workloads (reuse_measured=True only)
    measured_memo: int = 0

    @property
    def overlap_fraction(self) -> float:
        if self.measure_time_s <= 0:
            return 0.0
        return self.overlap_s / self.measure_time_s

    @property
    def mean_proposal_entropy(self) -> float:
        """Session-level proposal-convergence indicator: mean of the
        per-workload entropies (NaN when learning was off everywhere)."""
        vals = [r.proposal_entropy for r in self.reports
                if math.isfinite(r.proposal_entropy)]
        if not vals:
            return float("nan")
        return sum(vals) / len(vals)

    @property
    def tuned_latency(self) -> float:
        return sum(r.total_latency for r in self.reports)

    @property
    def fixed_latency(self) -> float:
        return sum(r.count * r.fixed_latency for r in self.reports)

    @property
    def speedup_vs_fixed(self) -> float:
        tuned = self.tuned_latency
        if not (tuned > 0):
            return float("nan")
        return self.fixed_latency / tuned

    def summary(self) -> dict:
        """JSON-able session summary (what the database stores)."""
        return {
            "model": self.model,
            "hw": self.hw.name,
            "runner": self.runner_name,
            "total_trials": self.total_trials,
            "wall_time_s": self.wall_time_s,
            "tuned_latency_s": self.tuned_latency,
            "fixed_latency_s": self.fixed_latency,
            "speedup_vs_fixed": self.speedup_vs_fixed,
            "interleaved": self.interleaved,
            "pipeline_depth": self.pipeline_depth,
            "measure_time_s": self.measure_time_s,
            "measure_span_s": self.measure_span_s,
            "multi_queue": self.multi_queue,
            "overlap_s": self.overlap_s,
            "overlap_fraction": self.overlap_fraction,
            "proposal_entropy": self.mean_proposal_entropy,
            "board_stats": self.board_stats,
            "adaptive_depth": self.adaptive_depth,
            "stop_policy": self.stop_policy,
            "stopped_early": self.stopped_early,
            "released_trials": self.released_trials,
            "reallocated_trials": self.reallocated_trials,
            "preemptions": self.preemptions,
            "build_cache": self.build_cache,
            "measured_memo": self.measured_memo,
            "workloads": [{
                "key": r.workload.key(),
                "count": r.count,
                "trials": r.trials,
                "best_latency_s": r.best_latency,
                "warm_started": r.warm_started,
                "speedup_vs_fixed": r.speedup_vs_fixed,
                "proposal_entropy": r.proposal_entropy,
                "stopped_early": r.stopped_early,
                "budget_granted": r.budget_granted,
            } for r in self.reports],
        }


def dedup_workloads(ops: ModelConfig) -> list[tuple[int, Workload]]:
    """Collapse a model config to unique workloads (first-seen order),
    summing repeat counts — the session's unit of tuning work."""
    order: list[str] = []
    counts: dict[str, int] = {}
    by_key: dict[str, Workload] = {}
    for count, wl in ops:
        key = wl.key()
        if key not in counts:
            order.append(key)
            counts[key] = 0
            by_key[key] = wl
        counts[key] += count
    return [(counts[k], by_key[k]) for k in order]


def split_budget(weights: Sequence[float], total: int,
                 floor: int = 4) -> list[int]:
    """Deterministic proportional split of ``total`` trials with a floor.

    Every entry gets at least ``floor``; the remainder is distributed
    proportionally to ``weights`` (largest-remainder rounding), so the sum is
    exactly ``max(total, len(weights) * floor)``.
    """
    n = len(weights)
    if n == 0:
        return []
    total = max(int(total), n * floor)
    spare = total - n * floor
    wpos = [max(w, 0.0) for w in weights]
    wsum = sum(wpos)
    if wsum <= 0:  # degenerate weights: split the spare evenly
        wpos, wsum = [1.0] * n, float(n)
    raw = [spare * w / wsum for w in wpos]
    alloc = [floor + int(r) for r in raw]
    # largest fractional remainders absorb the rounding slack (ties: earlier
    # workloads first, keeping the split deterministic)
    leftover = total - sum(alloc)
    by_frac = sorted(range(n), key=lambda i: (-(raw[i] - int(raw[i])), i))
    for i in by_frac[:leftover]:
        alloc[i] += 1
    return alloc


@dataclasses.dataclass
class TuningSession:
    """Tune every unique workload of a model under one shared trial budget,
    warm-starting from (and committing back to) the tuning database.

    ``interleave=None`` (auto) overlaps measurement and search across
    workloads whenever the runner declares ``overlap_capable``; set it
    explicitly to force either path. ``multi_queue=None`` (auto) lets the
    scheduler hold every driver's batches in flight concurrently whenever
    the runner exposes a native async ``submit_batch``;
    ``False`` forces the single-FIFO measurement thread (the comparison
    baseline — per-workload results are bit-identical either way).
    ``pipeline_depth`` is the per-workload in-flight batch bound (see
    ``tuner.tune``). ``learn_proposals`` turns the per-decision proposal
    learning on (default) — each search is then additionally warm-started
    from the blended posteriors prior same-op-family searches stored in the
    database; ``pretrain_cost_model`` folds the database's records into
    each search's cost model before its first generation.

    Adaptation knobs (see the module docstring; all off by default, and
    all apply to the interleaved path — the serial path has nothing to
    adapt): ``adaptive_depth``/``max_depth``/``target_utilization``/
    ``depth_window_s`` configure the
    :class:`~repro_torch.core.measure_scheduler.AdaptiveDepthPolicy`;
    ``stop_policy="entropy"`` plus ``entropy_threshold``/
    ``plateau_patience``/``reallocate_fraction`` configure the
    :class:`EntropyStopPolicy` over a shared :class:`BudgetLedger`
    (requires ``learn_proposals``); ``priority`` tags every batch for
    priority-aware backends.
    """

    hw: HardwareConfig
    runner: Runner
    database: TuningDatabase | None = None
    warm_start_limit: int = 4
    min_trials: int = 4
    batch: int = 8
    pipeline_depth: int = 1
    interleave: bool | None = None
    multi_queue: bool | None = None
    learn_proposals: bool = True
    pretrain_cost_model: bool = False
    # consult the static feasibility analyzer so provably-invalid
    # candidates are never proposed (see core/static_analysis.py); False
    # restores the purely-dynamic pre-analyzer sampler
    static_analysis: bool = True
    # ---- adaptation (all off by default) ----
    adaptive_depth: bool = False
    max_depth: int = 8
    target_utilization: float = 0.75
    depth_window_s: float = 2.0
    stop_policy: str = "none"  # "none" | "entropy"
    entropy_threshold: float = 0.995
    plateau_patience: int = 12
    reallocate_fraction: float = 1.0
    priority: int = 0
    # settle candidates the database already measured (same runner name)
    # from the stored latency instead of re-measuring — the cross-session
    # memo (database.measured_latency). Off by default: reuse changes
    # which candidates receive fresh measurements.
    reuse_measured: bool = False
    log: Callable[[str], None] | None = None

    def _log(self, msg: str) -> None:
        if self.log:
            self.log(msg)

    def _seeds_for(self, wl: Workload) -> list[Schedule]:
        if self.database is None:
            return []
        return self.database.transfer_candidates(wl, self.hw.name,
                                                 limit=self.warm_start_limit)

    def _priors_for(self, wl: Workload) -> dict | None:
        """Blended proposal priors from the database (None when learning is
        off, there is no database, or nothing transferable was stored)."""
        if self.database is None or not self.learn_proposals:
            return None
        return self.database.transfer_distributions(
            wl, self.hw.name, limit=self.warm_start_limit) or None

    def _measure_baselines(self, unique) -> list[float]:
        """Fixed-library baselines for every unique workload through one
        scheduled wave: all baselines are submitted before any is awaited,
        so a multi-target backend measures them in parallel instead of N serial
        dispatch round trips (per-workload attribution is by position)."""
        from repro_torch.core.dispatch import fixed_library_schedule

        pairs = [(wl, fixed_library_schedule(wl, self.hw))
                 for _, wl in unique]
        scheduler = MeasureScheduler(self.runner,
                                     multi_queue=self.multi_queue)
        try:
            tickets = [scheduler.submit(i, wl, [s])
                       for i, (wl, s) in enumerate(pairs)]
            return [t.result()[0] for t in tickets]
        finally:
            scheduler.close()

    def _report_for(self, index: int, n_unique: int, count: int,
                    wl: Workload, res: TuneResult,
                    fixed: float) -> WorkloadReport:
        if not math.isfinite(fixed):  # library has no valid mapping here
            fixed = res.best_latency
        self._log(f"  [{index + 1}/{n_unique}] {wl.key()} x{count}: "
                  f"best {res.best_latency * 1e6:9.2f} us over "
                  f"{res.trials} trials"
                  f" (warm-start {res.warm_started})"
                  f", library {fixed * 1e6:9.2f} us")
        return WorkloadReport(
            workload=wl, count=count, trials=res.trials,
            best_latency=res.best_latency, best_schedule=res.best_schedule,
            warm_started=res.warm_started, fixed_latency=fixed,
            wall_time_s=res.wall_time_s,
            proposal_entropy=res.mean_proposal_entropy,
            stopped_early=res.stopped_early,
            budget_granted=res.budget_granted)

    # ---- execution paths -------------------------------------------------------
    def _tune_serial(self, unique, budgets,
                     seed) -> tuple[list[TuneResult], float, float]:
        """One workload at a time; workload i+1's warm-start query sees the
        records workload i just committed (within-session chaining).
        Returns the per-workload results, summed overlap seconds, and the
        measurement span (serial batches: the span is the sum)."""
        results = []
        for i, ((count, wl), trials) in enumerate(zip(unique, budgets)):
            results.append(tuner.tune(
                wl, self.hw, self.runner, trials=trials, seed=seed + i,
                database=self.database, batch=self.batch,
                warm_start=self._seeds_for(wl),
                pipeline_depth=self.pipeline_depth,
                learn_proposals=self.learn_proposals,
                prior_distributions=self._priors_for(wl),
                pretrain_cost_model=self.pretrain_cost_model,
                static_analysis=self.static_analysis,
                reuse_measured=self.reuse_measured))
        return (results, sum(r.overlap_s for r in results),
                sum(r.measure_time_s for r in results), {})

    def _tune_interleaved(self, unique, budgets, seed, depth,
                          scheduler) -> tuple[list[TuneResult], float, float]:
        """All drivers feed one MeasureScheduler: while workload A's batch
        measures, workloads B, C, ... evolve and submit — and on a
        multi-queue backend every driver's batches are *measured*
        concurrently too. Each driver reconciles its own batches in
        submission order, so per-workload results are deterministic for a
        given seed regardless of completion order. Session-level overlap
        and measurement span come from the scheduler's real busy/wait
        intervals (span-accurate under concurrency, unlike the old
        summed-totals estimate), with per-driver wait/overlap attribution
        from each driver's own wait intervals (``wait_span_s(key=)``).

        The adaptation knobs plug in here: the depth policy supplies each
        driver's effective depth per top-up, the entropy stop policy runs
        as the reconcile hook over one shared ledger. Both are None/absent
        by default, leaving the executor bit-identical to the non-adaptive
        session."""
        from repro_torch.core.measure_scheduler import AdaptiveDepthPolicy

        drivers = [
            tuner.TuneDriver(wl, self.hw, self.runner, trials=trials,
                             seed=seed + i, database=self.database,
                             batch=self.batch, warm_start=self._seeds_for(wl),
                             learn_proposals=self.learn_proposals,
                             prior_distributions=self._priors_for(wl),
                             pretrain_cost_model=self.pretrain_cost_model,
                             static_analysis=self.static_analysis,
                             priority=self.priority,
                             reuse_measured=self.reuse_measured)
            for i, ((count, wl), trials) in enumerate(zip(unique, budgets))]
        depth_policy = None
        # adaptive depth can grow from base depth 1 — that is exactly the
        # heterogeneous-backend win — but never on a runner with nothing to
        # overlap (analytic runners stay clamped at depth 1, bit-identical)
        if self.adaptive_depth and getattr(self.runner, "overlap_capable",
                                           False):
            depth_policy = AdaptiveDepthPolicy(
                depth, max_depth=self.max_depth,
                target_utilization=self.target_utilization,
                window_s=self.depth_window_s)
        ledger = stop = None
        if self.stop_policy == "entropy":
            ledger = BudgetLedger(
                reallocate_fraction=self.reallocate_fraction)
            stop = EntropyStopPolicy(
                ledger, entropy_threshold=self.entropy_threshold,
                plateau_patience=self.plateau_patience, log=self.log)
        tuner.run_scheduled(drivers, self.runner, depth, scheduler=scheduler,
                            depth_policy=depth_policy, on_reconcile=stop)
        results = [d.finish(pipeline_depth=depth) for d in drivers]
        extras = {
            "adaptive_depth": depth_policy is not None,
            "stopped_early": stop.stops if stop else 0,
            "released_trials": ledger.released if ledger else 0,
            "reallocated_trials": ledger.granted if ledger else 0,
        }
        return (results, scheduler.overlap_s(), scheduler.measure_span_s(),
                extras)

    def tune_model(self, ops: ModelConfig, total_trials: int = 256,
                   seed: int = 0, model: str = "") -> SessionResult:
        if self.stop_policy not in ("none", "entropy"):
            raise ValueError(
                f"unknown stop_policy {self.stop_policy!r} "
                "(expected 'none' or 'entropy')")
        t_start = time.perf_counter()
        bc_before = build_cache_stats()
        ops = list(ops)
        unique = dedup_workloads(ops)
        weights = [count * wl.flops() for count, wl in unique]
        budgets = split_budget(weights, total_trials, floor=self.min_trials)
        interleave = (self.interleave if self.interleave is not None
                      else getattr(self.runner, "overlap_capable", False)
                      and len(unique) > 1)
        # The scheduler is the authority on the effective queue mode (a
        # multi_queue=True request degrades to single-FIFO on runners
        # without the native submission protocol); constructing it here is
        # cheap (no threads until the first submit) and what is logged and
        # reported can then never diverge from what actually ran.
        scheduler = (MeasureScheduler(self.runner,
                                      multi_queue=self.multi_queue)
                     if interleave else None)
        multi_queue = scheduler.multi_queue if scheduler else False
        # Same clamp tune() applies: speculation depth > 1 only makes sense
        # against a runner with real measurement latency.
        depth = tuner.effective_pipeline_depth(self.runner,
                                               max(1, self.pipeline_depth))
        self._log(f"session: {len(ops)} ops -> {len(unique)} unique "
                  f"workloads, {sum(budgets)} trials on {self.runner.name}"
                  f"/{self.hw.name}"
                  + (f" (interleaved, depth {depth}"
                     + (", multi-queue" if multi_queue else "") + ")"
                     if interleave else ""))

        if interleave:
            results, overlap_s, span_s, extras = self._tune_interleaved(
                unique, budgets, seed, depth, scheduler)
        else:
            # adaptation is an interleaved-executor concern: the serial
            # path has no scheduler to adapt and no shared ledger
            results, overlap_s, span_s, extras = self._tune_serial(
                unique, budgets, seed)
        with tracing.span("session.baselines"):
            baselines = self._measure_baselines(unique)
        reports = [self._report_for(i, len(unique), count, wl, res, fixed)
                   for i, ((count, wl), res, fixed)
                   in enumerate(zip(unique, results, baselines))]

        measure_s = sum(r.measure_time_s for r in results)
        search_s = sum(r.search_time_s for r in results)
        summary_fn = getattr(self.runner, "farm_summary", None)
        board_stats = summary_fn() if callable(summary_fn) else None
        result = SessionResult(
            hw=self.hw, runner_name=self.runner.name, reports=reports,
            total_trials=sum(r.trials for r in reports),
            wall_time_s=time.perf_counter() - t_start,
            interleaved=interleave, pipeline_depth=depth,
            measure_time_s=measure_s, overlap_s=overlap_s,
            search_time_s=search_s, measure_span_s=span_s,
            multi_queue=multi_queue, model=model,
            board_stats=board_stats,
            adaptive_depth=extras.get("adaptive_depth", False),
            stop_policy=self.stop_policy if interleave else "none",
            stopped_early=extras.get("stopped_early", 0),
            released_trials=extras.get("released_trials", 0),
            reallocated_trials=extras.get("reallocated_trials", 0),
            preemptions=(board_stats or {}).get("preemptions", 0),
            build_cache=stats_delta(build_cache_stats(), bc_before),
            measured_memo=sum(r.measured_memo for r in results))
        if self.database is not None:
            self.database.add_session(result.summary())
            if self.database.path:
                self.database.save()
        self._log(f"session: tuned {result.tuned_latency * 1e6:.1f} us vs "
                  f"library {result.fixed_latency * 1e6:.1f} us "
                  f"({result.speedup_vs_fixed:.2f}x) in "
                  f"{result.wall_time_s:.1f}s"
                  + (f", overlap {result.overlap_fraction:.0%}"
                     if result.measure_time_s > 0 and interleave else ""))
        return result
