"""The port's board farm: every case of the JAX package's
tests/test_board_farm.py with its assertions, seeds and hypothesis
settings, over the port's simulated boards (``tests/_torch_sim_boards.py``,
on the port's ``AnalyticRunner``), plus parity with the JAX package: on
each of the determinism configurations a ``tune`` with the same seed gives
the same history, trial by trial, on the JAX package's ``simulated_farm``
and on the port's, and a ``TuningSession`` over both farms the same
reports.

One case differs from the reference's on purpose: the farm-size property
compares trajectories at equal effective pipeline depth (the reference's
version fails in every run; see its docstring). The reference's
``--runslow`` end-to-end LocalBoard farm is a card test in
``tests/test_torch_measure_pool.py``.
"""

import json
import math
import time

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import TuningSession as RefSession  # noqa: E402
from repro.core import V5E as REF_V5E  # noqa: E402
from repro.core import simulated_farm as ref_simulated_farm  # noqa: E402
from repro.core import tune as ref_tune  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402

from repro_torch.core import (AnalyticRunner, BoardFarm, FarmDead,  # noqa: E402
                              LocalBoard, Schedule, TraceSampler,
                              TuningDatabase, TuningSession, V5E, V5E_VMEM32,
                              INTERPRET, concretize, space_for, tune)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.runner import INVALID  # noqa: E402

import _pool_tasks  # noqa: E402
from _torch_sim_boards import (DETERMINISM_CONFIGS, RecordingMeasure,  # noqa: E402
                               die_fault, garbage_fault, hang_fault,
                               make_farm)


def _unique_samples(wl, hw, n, seed=0):
    space = space_for(wl, hw)
    sampler = TraceSampler(seed)
    out, sigs, tries = [], set(), 0
    while len(out) < n and tries < 200 * n:
        s = sampler.sample(space)
        tries += 1
        if concretize(wl, hw, s).valid and s.signature() not in sigs:
            sigs.add(s.signature())
            out.append(s)
    assert len(out) == n
    return out


WL = W.matmul(512, 512, 512, "bfloat16")
SCHEDULES = _unique_samples(WL, V5E, 10)
REFERENCE = AnalyticRunner(V5E).run_batch(WL, SCHEDULES)


# ----------------------------------------------------- sharding + order ----

def test_farm_shards_across_boards_and_reconciles_in_submission_order():
    farm = make_farm(3, delay_s=[0.001, 0.003, 0.002])
    got = farm.run_batch(WL, SCHEDULES)
    # aligned with submission order and bit-identical to one board measuring
    # everything, even though three boards finished out of order
    assert got == REFERENCE
    summary = farm.farm_summary()
    per_board = [b["completed"] for b in summary["boards"].values()]
    assert sum(per_board) == len(SCHEDULES)
    assert all(c > 0 for c in per_board)  # work stealing kept every board busy
    assert summary["requeues"] == 0


def test_farm_runner_protocol_single_run():
    farm = make_farm(2)
    assert farm.run(WL, SCHEDULES[0]) == REFERENCE[0]
    assert farm.overlap_capable  # drops into the pipelined tuner/session


@pytest.mark.parametrize("name,n,delays,capacity", DETERMINISM_CONFIGS)
def test_farm_results_bit_identical_to_single_board(name, n, delays, capacity):
    """Acceptance: fixed-seed farm results match the single-board run across
    >= 3 simulated board configurations (count/latency-script sweeps)."""
    farm = make_farm(n, delay_s=delays, capacity=capacity)
    assert farm.run_batch(WL, SCHEDULES) == REFERENCE


def test_farm_sync_tune_matches_plain_analytic_trajectory():
    """At depth 1 the farm is just a slower board: the whole tune()
    trajectory must equal the plain analytic runner's, bit-identical."""
    plain = tune(WL, V5E, AnalyticRunner(V5E), trials=16, seed=5)
    farmed = tune(WL, V5E, make_farm(3, delay_s=[0.0, 0.002, 0.001]),
                  trials=16, seed=5)
    assert farmed.history == plain.history
    assert farmed.best_schedule == plain.best_schedule
    assert farmed.best_latency == plain.best_latency


def test_farm_pipelined_tune_matches_single_board_farm():
    """Pipelined (speculative) search over a 4-board farm replays the
    1-board farm's trajectory exactly: completion order never leaks in."""
    r4 = tune(WL, V5E, make_farm(4, delay_s=[0.002, 0.0, 0.003, 0.001]),
              trials=16, seed=3, pipeline_depth=2)
    r1 = tune(WL, V5E, make_farm(1), trials=16, seed=3, pipeline_depth=2)
    assert r4.pipeline_depth == 2
    assert r4.history == r1.history
    assert r4.best_schedule == r1.best_schedule
    assert r4.board_stats is not None
    assert len(r4.board_stats["boards"]) == 4


# --------------------------------------------------------- fault scripts ----

def test_dead_board_candidates_requeue_onto_survivors_exactly_once():
    recorder = RecordingMeasure(V5E)
    farm = make_farm(2, capacity=2, measure_fn=recorder,
                     faults={0: [die_fault(batch=1, after=1)]},
                     straggler_timeout_s=10.0)
    got = farm.run_batch(WL, SCHEDULES)
    assert got == REFERENCE  # every candidate landed, none INVALID
    boards = farm.boards
    assert boards[0].stats.deaths == 1 and not boards[0].healthy
    # exactly-once acceptance: accepted measurements cover the batch with no
    # duplicates — the dead board's shard moved to the survivor, once
    assert sum(b.stats.completed for b in boards) == len(SCHEDULES)
    assert farm.requeues >= 1 and farm.retry_exhausted == 0
    # the death wasted exactly the work scripted before it (after=1), so the
    # requeued candidates were measured once more on the survivor
    wasted = sum(recorder.calls.values()) - len(SCHEDULES)
    assert wasted == 1


def test_straggler_board_is_abandoned_within_budget():
    """A board that hangs past its deadline is killed from the farm's
    clock, not the hang's: the batch completes on the survivor well inside
    the scripted 30 s wedge."""
    t0 = time.monotonic()
    farm = make_farm(2, faults={0: [hang_fault(batch=0, cap_s=30.0)]},
                     straggler_timeout_s=0.3)
    got = farm.run_batch(WL, SCHEDULES)
    elapsed = time.monotonic() - t0
    assert got == REFERENCE
    assert elapsed < 10.0  # nowhere near the hang: the deadline is real
    assert farm.boards[0].stats.deaths == 1
    assert not farm.boards[0].healthy
    assert farm.requeues >= 1


@pytest.mark.parametrize("value", [-2.5, 0.0, float("nan")])
def test_garbage_latencies_are_sanitized_to_invalid(value):
    """Non-physical readings — negative, NaN, and in particular an exact
    zero, which would otherwise be an unbeatable fake best that ranks first
    in the database forever — become INVALID, never a recorded latency."""
    farm = make_farm(2, capacity=2,
                     faults={0: [garbage_fault(batch=0, value=value)]})
    got = farm.run_batch(WL, SCHEDULES)
    # board 0 takes the first shard (indices 0-1) and returns garbage
    assert got[0] == INVALID and got[1] == INVALID
    assert got[2:] == REFERENCE[2:]
    assert farm.garbage_sanitized == 2
    assert farm.boards[0].healthy  # garbage is a bad reading, not a death


def test_board_comes_back_after_respawn():
    farm = make_farm(1, capacity=2, faults={0: [die_fault(batch=1)]},
                     respawns={0: 1}, straggler_timeout_s=10.0)
    got = farm.run_batch(WL, SCHEDULES)
    board = farm.boards[0]
    assert got == REFERENCE  # the respawned board finished the batch
    assert board.stats.deaths == 1 and board.stats.respawns == 1
    assert board.healthy
    statuses = [status for _, _, status in board.log]
    assert "die" in statuses
    assert statuses[-1] == "ok"  # measured again after coming back


def test_losing_all_boards_raises_clean_error_not_deadlock():
    t0 = time.monotonic()
    farm = make_farm(2, faults={0: [die_fault(batch=0)],
                                1: [die_fault(batch=0)]},
                     straggler_timeout_s=10.0)
    with pytest.raises(FarmDead, match="unmeasured"):
        farm.run_batch(WL, SCHEDULES)
    assert time.monotonic() - t0 < 5.0


def test_farm_death_propagates_through_pipelined_tune():
    """The FIFO measurement queue must fail fast when the farm dies, not
    wedge the driver loop waiting on a batch that can never land."""
    farm = make_farm(2, faults={0: [die_fault(batch=1)],
                                1: [die_fault(batch=1)]},
                     straggler_timeout_s=10.0)
    t0 = time.monotonic()
    with pytest.raises(FarmDead):
        tune(WL, V5E, farm, trials=24, seed=0, pipeline_depth=2)
    assert time.monotonic() - t0 < 20.0


def test_candidate_that_kills_every_board_goes_invalid_after_retries():
    """Bounded retries: with max_retries=0 a requeued candidate is spent
    immediately — INVALID — instead of circling the farm forever."""
    farm = make_farm(2, capacity=2, faults={0: [die_fault(batch=0)]},
                     respawns={0: 1}, max_retries=0,
                     straggler_timeout_s=10.0)
    got = farm.run_batch(WL, SCHEDULES)
    assert got[0] == INVALID and got[1] == INVALID  # board 0's first shard
    assert got[2:] == REFERENCE[2:]
    assert farm.retry_exhausted == 2 and farm.requeues == 0


# ------------------------------------------------- determinism properties ----

@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_property_reconciled_results_match_single_board(data):
    """Random board counts / latency scripts / capacities: the reconciled
    results never depend on farm shape or completion order."""
    n = data.draw(st.integers(min_value=1, max_value=5), label="boards")
    delays = data.draw(st.lists(
        st.sampled_from([0.0, 0.0005, 0.001, 0.003]),
        min_size=n, max_size=n), label="delays")
    capacity = data.draw(st.integers(min_value=1, max_value=3),
                         label="capacity")
    farm = make_farm(n, delay_s=delays, capacity=capacity)
    assert farm.run_batch(WL, SCHEDULES) == REFERENCE


@settings(max_examples=6, deadline=None)
@given(n=st.integers(min_value=1, max_value=4),
       seed=st.integers(min_value=0, max_value=3),
       depth=st.integers(min_value=1, max_value=3))
def test_property_tune_trajectory_identical_across_farm_sizes(n, seed, depth):
    """The full pipelined tune() trajectory on a random-size farm is
    bit-identical to the run on the smallest farm that reaches the same
    effective depth, for the same seed. The reference compares with one
    board at the requested depth, but ``effective_pipeline_depth`` clamps
    the depth to ``max_inflight + 1`` and a farm's ``max_inflight`` is its
    board count, so at depth 3 one board speculates less than two do; the
    comparison here is at equal effective depth."""
    wl = W.matmul(256, 512, 512, "bfloat16")
    farmed = tune(wl, V5E, make_farm(n, delay_s=[0.001] * n), trials=10,
                  seed=seed, pipeline_depth=depth)
    eff = farmed.pipeline_depth
    single = tune(wl, V5E, make_farm(max(1, eff - 1)), trials=10, seed=seed,
                  pipeline_depth=eff)
    assert single.pipeline_depth == eff
    assert farmed.history == single.history
    assert farmed.best_schedule == single.best_schedule


# ------------------------------------------------------ sessions + stats ----

def test_farm_session_matches_single_board_session():
    """Across the session layer too: same seed, same reports whether one
    board or three measured (different op families, fresh databases, so
    serial-vs-interleaved warm-start chaining cannot diverge)."""
    ops = [(1, W.matmul(128, 128, 128, "bfloat16")), (2, W.vmacc(64, 256))]
    single = TuningSession(V5E, AnalyticRunner(V5E),
                           database=TuningDatabase()).tune_model(
        ops, total_trials=16, seed=0)
    farmed = TuningSession(V5E, make_farm(3, delay_s=[0.0, 0.002, 0.001]),
                           database=TuningDatabase()).tune_model(
        ops, total_trials=16, seed=0)
    assert farmed.interleaved  # farm is overlap-capable
    for a, b in zip(single.reports, farmed.reports):
        assert a.best_schedule == b.best_schedule
        assert a.best_latency == b.best_latency
        assert a.trials == b.trials


def test_session_summary_carries_board_utilization_and_requeues(tmp_path):
    ops = [(1, W.matmul(128, 128, 128, "bfloat16")), (2, W.vmacc(64, 256))]
    db = TuningDatabase(str(tmp_path / "db.json"))
    farm = make_farm(3, delay_s=0.001,
                     faults={2: [die_fault(batch=1, after=0)]},
                     straggler_timeout_s=10.0)
    res = TuningSession(V5E, farm, database=db).tune_model(
        ops, total_trials=16, seed=0, model="farm-model")
    assert res.board_stats is not None
    boards = res.board_stats["boards"]
    assert set(boards) == {"sim0", "sim1", "sim2"}
    # completed covers the measured trials plus the fixed-library baselines
    assert sum(b["completed"] for b in boards.values()) >= res.total_trials
    for b in boards.values():
        assert 0.0 <= b["utilization"] <= 1.0 + 1e-6
    assert res.board_stats["requeues"] >= 1  # the scripted death shows up
    assert boards["sim2"]["deaths"] == 1
    # summaries survive strict-JSON persistence with the stats intact
    db2 = TuningDatabase(str(tmp_path / "db.json"))
    stored = db2.sessions[0]["board_stats"]
    assert stored["boards"]["sim2"]["deaths"] == 1
    assert stored["requeues"] == res.board_stats["requeues"]


def test_non_farm_runners_report_no_board_stats():
    res = tune(W.vmacc(64, 128), V5E, AnalyticRunner(V5E), trials=8, seed=0)
    assert res.board_stats is None
    ses = TuningSession(V5E, AnalyticRunner(V5E)).tune_model(
        [(1, W.vmacc(64, 128))], total_trials=4, seed=0)
    assert ses.board_stats is None
    assert ses.summary()["board_stats"] is None


# ---------------------------------------------------------- local boards ----

def test_local_board_farm_measures_through_pools():
    """LocalBoards run their candidates in real MeasurePool worker
    processes; the farm collects the per-board results in order."""
    wl = W.vmacc(8, 8)
    schedules = [Schedule.fixed(variant=f"v{i}") for i in range(4)]
    boards = [LocalBoard(f"local{i}", INTERPRET, workers=1,
                         task=_pool_tasks.fixed_latency) for i in range(2)]
    with BoardFarm(boards, straggler_timeout_s=60.0) as farm:
        lats = farm.run_batch(wl, schedules)
        assert lats == [1.5e-3] * 4
        assert sum(b.stats.completed for b in boards) == 4


def test_local_board_task_errors_surface_as_invalid_not_death():
    wl = W.vmacc(8, 8)
    schedules = [Schedule.fixed(variant="a"), Schedule.fixed(variant="b")]
    boards = [LocalBoard("err", INTERPRET, workers=1,
                         task=_pool_tasks.boom)]
    with BoardFarm(boards, straggler_timeout_s=60.0) as farm:
        lats = farm.run_batch(wl, schedules)
        assert lats == [INVALID, INVALID]
        assert boards[0].healthy  # candidate errors never kill the board


# ------------------------------------------------------- transfer smoke ----

def test_transfer_warm_start_not_worse_at_equal_budget():
    """ROADMAP transfer-study smoke: seeding a search from a near-miss
    record (same shape, different hardware config) at equal trial budget is
    never worse than the cold search on at least one shape pair."""
    pairs = [
        # same shape carried across the hardware sweep (paper Fig. 4)
        (W.matmul(512, 512, 512, "bfloat16"), V5E,
         W.matmul(512, 512, 512, "bfloat16"), V5E_VMEM32),
        # near-miss shape on the same hardware
        (W.matmul(512, 512, 512, "bfloat16"), V5E,
         W.matmul(512, 512, 640, "bfloat16"), V5E),
    ]
    wins = 0
    for prior_wl, prior_hw, target_wl, target_hw in pairs:
        db = TuningDatabase()
        tune(prior_wl, prior_hw, AnalyticRunner(prior_hw), trials=24, seed=0,
             database=db)
        seeds = db.transfer_candidates(target_wl, target_hw.name, limit=4)
        assert seeds  # same op family: the query must surface candidates
        runner = AnalyticRunner(target_hw)
        warm = tune(target_wl, target_hw, runner, trials=12, seed=1,
                    warm_start=seeds)
        cold = tune(target_wl, target_hw, runner, trials=12, seed=1)
        assert warm.trials == cold.trials == 12  # equal budget
        if warm.warm_started >= 1 and warm.best_latency <= cold.best_latency:
            wins += 1
    assert wins >= 1


# ------------------------------------------------- parity with the JAX farm ----

def _history(res):
    return [(json.dumps(s.to_json()), lat) for s, lat in res.history]


@pytest.mark.parametrize("name,n,delays,capacity", DETERMINISM_CONFIGS)
def test_farm_tune_history_equals_the_jax_packages(name, n, delays,
                                                   capacity):
    """The same seed on the JAX package's simulated farm and on the port's,
    same board count, latency script and capacity: the same history, trial
    by trial (schedule and latency), and the same best."""
    wl, ref_wl = (W.matmul(512, 512, 512, "bfloat16"),
                  ref_W.matmul(512, 512, 512, "bfloat16"))
    ours = tune(wl, V5E, make_farm(n, delay_s=delays, capacity=capacity),
                trials=16, seed=3, pipeline_depth=2)
    theirs = ref_tune(ref_wl, REF_V5E,
                      ref_simulated_farm(n, REF_V5E, delay_s=delays,
                                         capacity=capacity),
                      trials=16, seed=3, pipeline_depth=2)
    assert ours.pipeline_depth == theirs.pipeline_depth == 2
    assert _history(ours) == _history(theirs)
    assert ours.best_latency == theirs.best_latency
    assert ours.best_schedule.to_json() == theirs.best_schedule.to_json()


def test_farm_session_reports_equal_the_jax_packages():
    """A TuningSession over a three-board farm in each package, fresh
    databases and the same seed: equal reports workload by workload."""
    ops = [(1, W.matmul(128, 128, 128, "bfloat16")), (2, W.vmacc(64, 256))]
    ref_ops = [(1, ref_W.matmul(128, 128, 128, "bfloat16")),
               (2, ref_W.vmacc(64, 256))]
    delays = [0.0, 0.002, 0.001]
    ours = TuningSession(V5E, make_farm(3, delay_s=delays),
                         database=TuningDatabase()).tune_model(
        ops, total_trials=16, seed=0)
    theirs = RefSession(REF_V5E, ref_simulated_farm(3, REF_V5E,
                                                    delay_s=delays),
                        database=RefDatabase()).tune_model(
        ref_ops, total_trials=16, seed=0)
    assert ours.interleaved and theirs.interleaved
    assert len(ours.reports) == len(theirs.reports) == 2
    for a, b in zip(ours.reports, theirs.reports):
        assert a.workload.key() == b.workload.key()
        assert a.best_schedule.to_json() == b.best_schedule.to_json()
        assert a.best_latency == b.best_latency
        assert a.fixed_latency == b.fixed_latency
        assert a.trials == b.trials
    assert ours.board_stats is not None
    assert set(ours.board_stats["boards"]) == set(theirs.board_stats["boards"])
