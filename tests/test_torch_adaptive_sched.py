"""The port's adaptive measurement scheduling: every case of the JAX
package's tests/test_adaptive_sched.py with its assertions, seeds and
hypothesis settings, over the port's scheduler and simulated boards
(``tests/_torch_sim_boards.py``).

Covers :class:`AdaptiveDepthPolicy` decisions on scripted scheduler state
(grow / lag-shrink / backend cap / cooldown), the span-derived
``busy_fraction`` and per-key ``wait_span_s`` accounting, the
``max_inflight`` speculation-depth clamp, farm priority preemption with
aging anti-starvation, the :class:`BudgetLedger`/:class:`EntropyStopPolicy`
pair, and the determinism contracts: priorities and adaptation-off leave
per-driver histories bit-identical, and a curtailed search's history is a
deterministic prefix of its uncurtailed history.
"""

import time

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (AdaptiveDepthPolicy, AnalyticRunner,
                              BudgetLedger, EntropyStopPolicy,
                              MeasureScheduler, TuningDatabase,
                              TuningSession, V5E, tune)
from repro_torch.core import tuner as tuner_lib
from repro_torch.core import workload as W
from repro_torch.core.board_farm import _WorkItem

from _torch_sim_boards import die_fault, make_farm
from _torch_test_runners import SlowAnalytic


WL_A = W.matmul(128, 128, 128, "bfloat16")
WL_B = W.vmacc(64, 256)
WL_C = W.matmul(256, 128, 128, "bfloat16")


def _schedules(wl, n, seed=0):
    from repro_torch.core import TraceSampler, concretize, space_for

    space = space_for(wl, V5E)
    sampler = TraceSampler(seed)
    out, sigs = [], set()
    tries = 0
    while len(out) < n and tries < 500 * n:
        tries += 1
        s = sampler.sample(space)
        if concretize(wl, V5E, s).valid and s.signature() not in sigs:
            sigs.add(s.signature())
            out.append(s)
    assert len(out) == n
    return out


class _ScriptedScheduler:
    """Stands in for a MeasureScheduler: the policy only ever reads
    ``busy_fraction`` and ``max_inflight``, both scripted here."""

    def __init__(self, busy=0.0, max_inflight=4):
        self.busy = busy
        self.max_inflight = max_inflight

    def busy_fraction(self, window_s=2.0):
        return self.busy


# ------------------------------------------------------ depth policy units ----

def test_depth_policy_grows_while_underutilized_up_to_max_depth():
    pol = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1)
    idle = _ScriptedScheduler(busy=0.2, max_inflight=4)
    for _ in range(6):
        pol.on_collect("k", idle, lag=0)
    assert pol.depth("k") == 4  # grew 1 -> 4, stopped at max_depth
    assert [d for _, _, d in pol.events] == [2, 3, 4]


def test_depth_policy_holds_at_target_utilization():
    pol = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1)
    busy = _ScriptedScheduler(busy=0.95, max_inflight=4)
    for _ in range(6):
        pol.on_collect("k", busy, lag=0)
    assert pol.depth("k") == 1 and not pol.events


def test_depth_policy_shrinks_on_reconciliation_lag():
    pol = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1, lag_threshold=2.0)
    idle = _ScriptedScheduler(busy=0.0, max_inflight=4)
    for _ in range(4):
        pol.on_collect("k", idle, lag=0)  # grow to 4
    assert pol.depth("k") == 4
    for _ in range(40):  # deep speculation went stale: mean lag > threshold
        pol.on_collect("k", idle, lag=30)
    assert pol.depth("k") == 1  # shrank back, never below base_depth


def test_depth_policy_caps_at_backend_inflight_plus_one():
    pol = AdaptiveDepthPolicy(1, max_depth=8, cooldown=1)
    small = _ScriptedScheduler(busy=0.0, max_inflight=2)
    for _ in range(10):
        pol.on_collect("k", small, lag=0)
    assert pol.depth("k") == 3  # min(max_depth, max_inflight + 1)


def test_depth_policy_clamps_down_when_backend_shrinks():
    pol = AdaptiveDepthPolicy(1, max_depth=8, cooldown=1)
    sched = _ScriptedScheduler(busy=0.0, max_inflight=4)
    for _ in range(6):
        pol.on_collect("k", sched, lag=0)
    assert pol.depth("k") == 5
    sched.max_inflight = 1  # boards died: the capacity hint fell
    pol.on_collect("k", sched, lag=0)
    assert pol.depth("k") == 2  # one step straight to the new cap


def test_depth_policy_cooldown_bounds_change_rate():
    pol = AdaptiveDepthPolicy(1, max_depth=8, cooldown=3)
    idle = _ScriptedScheduler(busy=0.0, max_inflight=8)
    for _ in range(7):
        pol.on_collect("k", idle, lag=0)
    # eligible on collects 1, 4, 7 only
    assert [c for c, _, _ in pol.events] == [1, 4, 7]


def test_depth_policy_tracks_keys_independently():
    pol = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1)
    idle = _ScriptedScheduler(busy=0.0, max_inflight=4)
    pol.on_collect("a", idle, lag=0)
    assert pol.depth("a") == 2 and pol.depth("b") == 1


# ------------------------------------------- span accounting for the policy ----

def test_busy_fraction_zero_before_any_recorded_span():
    sched = MeasureScheduler(AnalyticRunner(V5E))
    try:
        assert sched.busy_fraction() == 0.0
    finally:
        sched.close()


def test_busy_fraction_derived_from_recorded_spans():
    sched = MeasureScheduler(SlowAnalytic(V5E, 0.02))
    try:
        sched.submit(0, WL_A, _schedules(WL_A, 2))
        sched.collect_next()
        sched.submit(0, WL_A, _schedules(WL_A, 2, seed=1))
        sched.collect_next()
        # back-to-back blocking waits: the measuring spans dominate the
        # recorded horizon, so the single-slot backend reads near-busy
        assert 0.5 < sched.busy_fraction(10.0) <= 1.0
        # degenerate window: "now" is the last recorded wait edge, which
        # sits past the last measuring span — still well-defined
        assert 0.0 <= sched.busy_fraction(1e-6) <= 1.0
    finally:
        sched.close()


def test_wait_span_attributed_per_key_across_cadences():
    """Two drivers with very different cadence: the blocking-collect driver
    owns nearly all the wait span, the submit-then-work driver almost none,
    and the global span never exceeds the per-key sum (interval union)."""
    sched = MeasureScheduler(SlowAnalytic(V5E, 0.03))
    try:
        sched.submit("eager", WL_A, _schedules(WL_A, 2))
        sched.collect_next()  # blocks out the whole measurement
        sched.submit("busy", WL_C, _schedules(WL_C, 2))
        time.sleep(0.05)  # "search work" covering the measurement
        sched.collect_next()
        eager, busy = sched.wait_span_s("eager"), sched.wait_span_s("busy")
        assert eager > 0.02
        assert busy < 0.01
        assert sched.wait_span_s() <= eager + busy + 1e-9
        assert sched.wait_span_s(key="never") == 0.0
    finally:
        sched.close()


# ------------------------------------------------------------- depth clamp ----

def test_effective_depth_clamped_by_declared_inflight_hint():
    farm = make_farm(3)
    try:
        assert tuner_lib.effective_pipeline_depth(farm, 8) == 4
        assert tuner_lib.effective_pipeline_depth(farm, 2) == 2
    finally:
        farm.close()


def test_effective_depth_kept_when_hint_is_absent():
    # SlowAnalytic declares overlap_capable but no max_inflight: the
    # requested depth must be taken at face value (no clamp)
    assert tuner_lib.effective_pipeline_depth(SlowAnalytic(V5E), 3) == 3


def test_effective_depth_one_for_instantaneous_runner():
    assert tuner_lib.effective_pipeline_depth(AnalyticRunner(V5E), 5) == 1


def test_tune_reports_clamped_depth_and_trace():
    farm = make_farm(1, delay_s=0.001)
    try:
        res = tune(WL_B, V5E, farm, trials=4, seed=0, pipeline_depth=4)
        assert res.pipeline_depth == 2  # max_inflight 1 -> clamp to 2
        assert res.depth_trace[0] == (0, 2)  # fixed depth: single entry
        assert len(res.depth_trace) == 1
    finally:
        farm.close()
    sync = tune(WL_B, V5E, AnalyticRunner(V5E), trials=4, seed=0,
                pipeline_depth=4)
    assert sync.pipeline_depth == 1 and sync.depth_trace == [(0, 1)]


def test_adaptive_tune_records_depth_growth():
    farm = make_farm(4, delay_s=[0.01, 0.02, 0.03, 0.04])
    try:
        res = tune(W.matmul(256, 512, 512, "bfloat16"), V5E, farm,
                   trials=16, seed=0, batch=2, pipeline_depth=2,
                   adaptive_depth=True, max_depth=4)
        assert max(d for _, d in res.depth_trace) > 2
        assert res.depth_trace[0] == (0, 2)
    finally:
        farm.close()


# ---------------------------------------------------------------- priority ----

def test_priority_batch_preempts_queued_backlog():
    backlog_pop = _schedules(WL_A, 6)
    hi_pop = _schedules(WL_A, 1, seed=1)
    farm = make_farm(1, delay_s=0.03)
    try:
        backlog = farm.submit_batch(WL_A, backlog_pop, priority=0)
        hi = farm.submit_batch(WL_A, hi_pop, priority=5)
        hi_lats = hi.result()
        assert not backlog.done()  # jumped ahead of >= 4 queued candidates
        backlog_lats = backlog.result()
        assert farm.preemptions >= 1
        assert farm.farm_summary()["preemptions"] == farm.preemptions
    finally:
        farm.close()
    # priorities change completion order, never results
    ref = AnalyticRunner(V5E)
    assert hi_lats == ref.run_batch(WL_A, hi_pop)
    assert backlog_lats == ref.run_batch(WL_A, backlog_pop)


def test_equal_priority_dispatch_is_plain_fifo():
    farm = make_farm(1, delay_s=0.005)
    try:
        t1 = farm.submit_batch(WL_A, _schedules(WL_A, 3), priority=2)
        t2 = farm.submit_batch(WL_A, _schedules(WL_A, 3, seed=1), priority=2)
        t1.result(), t2.result()
        assert farm.preemptions == 0  # equal classes: nothing ever jumped
    finally:
        farm.close()


def test_aging_credit_bounds_starvation():
    """_take_shard_locked: a long-bypassed low-priority candidate's
    effective class rises by one per ``aging_every`` bypasses until it beats
    fresher high-priority work — starvation is bounded, not possible."""
    farm = make_farm(1, aging_every=2)
    try:
        lo = _WorkItem(None, 0, WL_A, None, priority=0, bypass=6)
        hi = _WorkItem(None, 0, WL_A, None, priority=2, bypass=0)
        with farm._mu:
            farm._work.clear()
            farm._work.extend([lo, hi])
            taken = farm._take_shard_locked(1)
        assert taken[0] is lo  # 0 + 6 // 2 = 3 beats 2
        # and a jumped candidate earns its credit on the way
        fresh_lo = _WorkItem(None, 0, WL_A, None, priority=0, bypass=0)
        hi2 = _WorkItem(None, 0, WL_A, None, priority=2, bypass=0)
        with farm._mu:
            farm._work.clear()
            farm._work.extend([fresh_lo, hi2])
            taken = farm._take_shard_locked(1)
        assert taken[0] is hi2 and fresh_lo.bypass == 1
        assert farm.preemptions >= 1
    finally:
        farm.close()


@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_property_priorities_never_change_results(data):
    """Random farm shapes, die faults, and per-driver priorities: every
    driver's history is bit-identical to the all-priority-0 run — priority
    affects completion order only."""
    n = data.draw(st.integers(min_value=2, max_value=4), label="boards")
    delays = data.draw(st.lists(
        st.sampled_from([0.0, 0.001, 0.003, 0.005]),
        min_size=n, max_size=n), label="delays")
    seed = data.draw(st.integers(min_value=0, max_value=5), label="seed")
    priorities = data.draw(st.lists(
        st.integers(min_value=0, max_value=3), min_size=3, max_size=3),
        label="priorities")
    faulty = data.draw(st.integers(min_value=-1, max_value=n - 1),
                       label="faulty_board")
    faults, respawns = {}, {}
    if faulty >= 0:
        faults[faulty] = [die_fault(batch=data.draw(
            st.integers(min_value=0, max_value=2), label="die_batch"))]
        respawns[faulty] = 1

    def run(prios):
        farm = make_farm(n, delay_s=delays, faults=dict(faults),
                         respawns=dict(respawns), straggler_timeout_s=10.0)
        try:
            drivers = [
                tuner_lib.TuneDriver(wl, V5E, farm, trials=6, seed=seed + i,
                                     batch=3, priority=prios[i])
                for i, wl in enumerate((WL_A, WL_B, WL_C))]
            tuner_lib.run_scheduled(drivers, farm, depth=1)
            return drivers
        finally:
            farm.close()

    for a, b in zip(run([0, 0, 0]), run(priorities)):
        assert a.history == b.history
        assert a.best_schedule == b.best_schedule


@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_property_adaptation_off_replays_plain_scheduler(data):
    """Random board counts, latency scripts, and die faults: run_scheduled
    with an explicit ``depth_policy=None`` + default priorities is
    bit-identical to the pre-adaptive executor across queue modes — the
    adaptation layer is provably inert when off."""
    n = data.draw(st.integers(min_value=2, max_value=4), label="boards")
    delays = data.draw(st.lists(
        st.sampled_from([0.0, 0.001, 0.003, 0.005]),
        min_size=n, max_size=n), label="delays")
    seed = data.draw(st.integers(min_value=0, max_value=5), label="seed")
    depth = data.draw(st.integers(min_value=1, max_value=2), label="depth")
    faulty = data.draw(st.integers(min_value=-1, max_value=n - 1),
                       label="faulty_board")
    faults, respawns = {}, {}
    if faulty >= 0:
        faults[faulty] = [die_fault(batch=data.draw(
            st.integers(min_value=0, max_value=2), label="die_batch"))]
        respawns[faulty] = 1

    def run(multi_queue):
        farm = make_farm(n, delay_s=delays, faults=dict(faults),
                         respawns=dict(respawns), straggler_timeout_s=10.0)
        try:
            drivers = [
                tuner_lib.TuneDriver(wl, V5E, farm, trials=6, seed=seed + i,
                                     batch=3)
                for i, wl in enumerate((WL_A, WL_B, WL_C))]
            tuner_lib.run_scheduled(drivers, farm, depth,
                                    multi_queue=multi_queue,
                                    depth_policy=None, on_reconcile=None)
            return drivers
        finally:
            farm.close()

    for a, b in zip(run(False), run(True)):
        assert a.history == b.history
        assert a.best_schedule == b.best_schedule


# ------------------------------------------------- budget ledger and stops ----

def test_budget_ledger_caps_grants_by_fraction():
    ledger = BudgetLedger(reallocate_fraction=0.5)
    ledger.release(40)
    assert ledger.available == 20
    assert ledger.draw(8) == 8
    assert ledger.draw(100) == 12  # remainder of the 50% cap
    assert ledger.draw(1) == 0
    assert (ledger.released, ledger.granted) == (40, 20)


def test_budget_ledger_zero_fraction_never_grants():
    ledger = BudgetLedger(reallocate_fraction=0.0)
    ledger.release(100)
    assert ledger.available == 0 and ledger.draw(8) == 0


class _FakeDriver:
    def __init__(self, remaining=10, plateau=0, entropy=None, batch=8):
        self.stopped_early = False
        self.plateau_len = plateau
        self.batch = batch
        self.workload = WL_A
        self._remaining = remaining
        self._entropy = entropy or {}
        self.extended = 0
        self.curtailed = False

    @property
    def remaining_trials(self):
        return self._remaining

    def proposal_entropy_now(self):
        return self._entropy

    def curtail(self):
        self.curtailed = True
        self.stopped_early = True
        released, self._remaining = self._remaining, 0
        return released

    def extend_budget(self, extra):
        self.extended += extra
        self._remaining += extra


def test_entropy_stop_curtails_converged_driver():
    ledger = BudgetLedger()
    stop = EntropyStopPolicy(ledger, entropy_threshold=0.9,
                             plateau_patience=5)
    d = _FakeDriver(remaining=30, plateau=6, entropy={"a": 0.5, "b": 0.7})
    stop(0, d)
    assert d.curtailed and ledger.released == 30 and stop.stops == 1
    stop(0, d)  # stays stopped, releases nothing twice
    assert ledger.released == 30 and stop.stops == 1


def test_entropy_stop_spares_exploring_or_uniform_drivers():
    ledger = BudgetLedger()
    stop = EntropyStopPolicy(ledger, entropy_threshold=0.9,
                             plateau_patience=5)
    short_plateau = _FakeDriver(remaining=30, plateau=2,
                                entropy={"a": 0.5})
    still_uniform = _FakeDriver(remaining=30, plateau=9,
                                entropy={"a": 0.99})
    learning_off = _FakeDriver(remaining=30, plateau=9, entropy={})
    for d in (short_plateau, still_uniform, learning_off):
        stop(0, d)
        assert not d.curtailed
    assert ledger.released == 0 and stop.stops == 0


def test_entropy_stop_grants_only_to_improving_exhausted_drivers():
    ledger = BudgetLedger()
    ledger.release(16)
    stop = EntropyStopPolicy(ledger, plateau_patience=5)
    improving = _FakeDriver(remaining=0, plateau=2, batch=8)
    plateaued = _FakeDriver(remaining=0, plateau=9, batch=8)
    stop(0, plateaued)
    assert plateaued.extended == 0  # converged-but-exhausted never draws
    stop(1, improving)
    assert improving.extended == 8 and ledger.granted == 8


def test_session_rejects_unknown_stop_policy():
    session = TuningSession(V5E, AnalyticRunner(V5E), stop_policy="magic")
    with pytest.raises(ValueError, match="stop_policy"):
        session.tune_model([(1, WL_B)], total_trials=4, seed=0)


# ------------------------------------- curtailment determinism, end to end ----

def _entropy_drivers(trials_list, stop=None):
    runner = AnalyticRunner(V5E)
    wls = [W.matmul(512, 2048, 2048, "bfloat16"),
           W.gemv(2048, 8192, "bfloat16")]
    drivers = [
        tuner_lib.TuneDriver(wl, V5E, runner, trials=trials, seed=i, batch=8,
                             database=TuningDatabase())
        for i, (wl, trials) in enumerate(zip(wls, trials_list))]
    tuner_lib.run_scheduled(drivers, runner, depth=1, on_reconcile=stop)
    return drivers


def test_curtailed_history_is_prefix_of_uncurtailed():
    """The entropy stop only truncates: a curtailed driver's history is a
    bit-identical prefix of the same driver's uncurtailed history, and a
    granted driver's history is a bit-identical extension of its own."""
    baseline = _entropy_drivers([95, 25])
    ledger = BudgetLedger(reallocate_fraction=0.5)
    stop = EntropyStopPolicy(ledger, plateau_patience=28)
    policy = _entropy_drivers([95, 25], stop=stop)
    curtailed, granted = policy
    assert curtailed.stopped_early and stop.stops == 1
    assert ledger.released > 0 and ledger.granted > 0
    base_curtailed, base_granted = baseline
    n = len(curtailed.history)
    assert 0 < n < len(base_curtailed.history)
    assert curtailed.history == base_curtailed.history[:n]
    m = len(base_granted.history)
    assert len(granted.history) > m
    assert granted.history[:m] == base_granted.history
    assert granted.budget_granted == ledger.granted


def test_entropy_session_spends_fewer_trials_at_equal_or_better_best():
    """Session-level contract (the sched benchmark asserts the same on the
    full budget): strictly fewer total measurements, equal-or-better best
    latency on every workload, counters surfaced in the summary."""
    ops = [(1, W.matmul(512, 2048, 2048, "bfloat16")),
           (1, W.gemv(2048, 8192, "bfloat16")),
           (1, W.vmacc(2048, 2048))]
    runs = {}
    for policy in ("none", "entropy"):
        runs[policy] = TuningSession(
            V5E, AnalyticRunner(V5E), database=TuningDatabase(),
            min_trials=24, interleave=True, stop_policy=policy,
            plateau_patience=28, reallocate_fraction=0.5).tune_model(
            ops, total_trials=144, seed=0, model="t")
    base, pol = runs["none"], runs["entropy"]
    assert pol.total_trials < base.total_trials
    assert pol.stopped_early >= 1
    assert pol.released_trials > 0
    for a, b in zip(base.reports, pol.reports):
        assert b.best_latency <= a.best_latency * (1 + 1e-9)
    summary = pol.summary()
    assert summary["stop_policy"] == "entropy"
    assert summary["stopped_early"] == pol.stopped_early
    assert summary["released_trials"] == pol.released_trials
    assert summary["reallocated_trials"] == pol.reallocated_trials
    assert base.summary()["stop_policy"] == "none"


# ------------------------------------------------------------ observability ----

def test_adaptive_session_summary_surfaces_adaptation():
    ops = [(1, WL_A), (1, WL_B)]
    farm = make_farm(2, delay_s=[0.002, 0.006])
    try:
        res = TuningSession(V5E, farm, database=TuningDatabase(), batch=2,
                            adaptive_depth=True, max_depth=3,
                            depth_window_s=0.5).tune_model(
            ops, total_trials=12, seed=0)
        assert res.adaptive_depth
        summary = res.summary()
        assert summary["adaptive_depth"] is True
        assert "preemptions" in summary
    finally:
        farm.close()


def test_serial_session_reports_adaptation_off():
    res = TuningSession(V5E, AnalyticRunner(V5E),
                        database=TuningDatabase(),
                        adaptive_depth=True).tune_model(
        [(1, WL_B)], total_trials=4, seed=0)
    # serial path (analytic, single workload): nothing to adapt
    assert not res.adaptive_depth and res.summary()["stop_policy"] == "none"
