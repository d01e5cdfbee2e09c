"""The port's measurement scheduler, pipelined tuner and tuning sessions.

- The non-farm cases of the JAX package's test_session.py,
  test_async_tuner.py, test_measure_scheduler.py and (scheduler side)
  test_adaptive_sched.py, with their assertions, on the port.
- Parity with the JAX package on the same seeds: an analytic MobileNetV2
  int8 session on ``V5E`` (serial, and interleaved at pipeline depth 2
  behind a slow runner) gives the same per-workload histories, records and
  best schedules; ``decode_ops`` of MobileLLM-125M, the port's configs and
  the port's copy of the networks equal the reference's.
- ``ensure_tuned`` fills only what is missing, and defaults to the card for
  a CUDA configuration (raising here, where there is none).
- An ``EmulateRunner`` session on a small network, interleaved.
"""

import dataclasses
import json
import math
import threading
import time

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from benchmarks import nets as ref_nets  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import AnalyticRunner as RefAnalytic  # noqa: E402
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import TuningSession as RefSession  # noqa: E402
from repro.core import V5E as REF_V5E  # noqa: E402
from repro.runtime.serve_loop import decode_ops as ref_decode_ops  # noqa: E402

from _test_runners import SlowAnalytic as RefSlowAnalytic  # noqa: E402
from _torch_test_runners import SlowAnalytic  # noqa: E402

from repro_torch import nets  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CPU_EMULATE, H100, V5E,  # noqa: E402
                              AdaptiveDepthPolicy, AnalyticRunner,
                              BudgetLedger, EmulateRunner, EntropyStopPolicy,
                              MeasureScheduler, MeasureTicket, Schedule,
                              SerialMeasureQueue, TraceSampler,
                              TuningDatabase, TuningSession, concretize,
                              dedup_workloads, ensure_tuned,
                              fixed_library_schedule, kernel_params,
                              space_for, split_budget, tune)
from repro_torch.core import tuner as tuner_lib  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.runner import INVALID, run_batch  # noqa: E402
from repro_torch.runtime.serve_loop import decode_ops  # noqa: E402

WL_A = W.matmul(128, 128, 128, "bfloat16")
WL_B = W.vmacc(64, 256)
WL_C = W.matmul(256, 128, 128, "bfloat16")


class ThreadedAsyncRunner:
    """A runner with the native submission protocol: each batch is measured
    on its own thread after a per-batch delay taken in turn from
    ``delays_s``, so batches complete out of submission order."""

    overlap_capable = True
    name = "threaded-async"

    def __init__(self, hw, delays_s=(0.0, 0.004, 0.002)):
        self.hw = hw
        self.max_inflight = len(delays_s)
        self._delays = list(delays_s)
        self._n = 0
        self._inner = AnalyticRunner(hw)

    def run(self, workload, schedule):
        return self._inner.run(workload, schedule)

    def run_batch(self, workload, schedules):
        return self._inner.run_batch(workload, schedules)

    def submit_batch(self, workload, schedules):
        ticket = MeasureTicket(workload, schedules)
        delay = self._delays[self._n % len(self._delays)]
        self._n += 1

        def work():
            time.sleep(delay)
            ticket._complete(self._inner.run_batch(workload, schedules))

        threading.Thread(target=work, daemon=True).start()
        return ticket


def _samples(wl, hw, n, seed=0):
    """n valid samples, unique when the space is large enough."""
    space = space_for(wl, hw)
    sampler = TraceSampler(seed)
    out, tries = [], 0
    while len(out) < n:
        s = sampler.sample(space)
        tries += 1
        if concretize(wl, hw, s).valid and (s not in out or tries > 50 * n):
            out.append(s)
    return out


def _schedules(wl, n, seed=0):
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


def _report_rows(res):
    return [(r.workload.key(), r.count, r.trials,
             json.dumps(r.best_schedule.to_json()), r.best_latency,
             r.fixed_latency, r.warm_started) for r in res.reports]


# ------------------------------------------------------------- run_batch ----

def test_analytic_run_batch_bit_identical_to_serial():
    wl = W.matmul(512, 1024, 768, "bfloat16")
    runner = AnalyticRunner(V5E)
    schedules = _samples(wl, V5E, 16)
    assert runner.run_batch(wl, schedules) == [runner.run(wl, s)
                                               for s in schedules]


def test_run_batch_helper_falls_back_to_serial_run():
    class SerialOnly:
        name = "serial"
        hw = V5E

        def run(self, workload, schedule):
            return 1e-3

    lats = run_batch(SerialOnly(), W.vmacc(8, 8),
                     _samples(W.vmacc(8, 8), V5E, 2))
    assert lats == [1e-3, 1e-3]


def test_emulate_run_batch_isolates_an_unknown_variant():
    """An unknown-variant candidate is INVALID, not batch-fatal."""
    wl = W.matmul(16, 16, 16, "float32")
    runner = EmulateRunner(CPU_EMULATE, repeats=1, warmup=0)
    good = _samples(wl, CPU_EMULATE, 2)
    bad = Schedule.fixed(variant="not_a_registered_variant")
    lats = runner.run_batch(wl, [good[0], bad, good[1]])
    assert math.isfinite(lats[0]) and math.isfinite(lats[2])
    assert lats[1] == INVALID


# ------------------------------------------------ session building blocks ----

def test_dedup_workloads_sums_counts_keeps_order():
    a, b = W.matmul(8, 8, 8), W.vmacc(8, 8)
    assert dedup_workloads([(2, a), (1, b), (3, a)]) == [(5, a), (1, b)]


def test_split_budget_floor_and_exact_sum():
    alloc = split_budget([100.0, 10.0, 1.0], total=64, floor=4)
    assert sum(alloc) == 64
    assert all(a >= 4 for a in alloc)
    assert alloc[0] > alloc[1] > alloc[2]
    assert split_budget([1.0, 1.0], total=2, floor=4) == [4, 4]
    assert split_budget([], total=10) == []
    assert split_budget([0.0, 0.0], total=64, floor=4) == [32, 32]
    assert alloc == split_budget([100.0, 10.0, 1.0], total=64, floor=4)


def test_transfer_candidates_ranks_exact_then_near():
    db = TuningDatabase()
    near = W.matmul(512, 512, 512, "bfloat16")
    far = W.matmul(16, 16, 16, "bfloat16")
    target = W.matmul(600, 512, 512, "bfloat16")
    db.add(near, V5E.name, Schedule.fixed(variant="mxu_512", tag="near"),
           2e-3, "analytic")
    db.add(far, V5E.name, Schedule.fixed(variant="mxu_min", tag="far"),
           1e-3, "analytic")
    db.add(target, V5E.name, Schedule.fixed(variant="mxu_512", tag="exact"),
           5e-3, "analytic")
    db.add(W.vmacc(8, 8), V5E.name, Schedule.fixed(variant="other_op"),
           1e-6, "analytic")
    seeds = db.transfer_candidates(target, V5E.name, limit=3)
    assert [s["tag"] for s in seeds] == ["exact", "near", "far"]


# ------------------------------------------------------- tuning sessions ----

def test_session_dedups_and_splits_budget(tmp_path):
    wl_a = W.matmul(256, 256, 256, "bfloat16")
    wl_b = W.vmacc(128, 1024)
    ops = [(2, wl_a), (1, wl_b), (4, wl_a)]
    db = TuningDatabase(str(tmp_path / "db.json"))
    res = TuningSession(V5E, AnalyticRunner(V5E), database=db).tune_model(
        ops, total_trials=24, seed=0)
    assert [r.workload for r in res.reports] == [wl_a, wl_b]
    assert res.reports[0].count == 6 and res.reports[1].count == 1
    assert res.total_trials == 24
    assert all(math.isfinite(r.best_latency) for r in res.reports)
    assert len(db.sessions) == 1 and db.sessions[0]["total_trials"] == 24
    db2 = TuningDatabase(str(tmp_path / "db.json"))
    assert {w["key"] for w in db2.sessions[0]["workloads"]} == \
        {wl_a.key(), wl_b.key()}


def test_session_warm_starts_from_database():
    prior = W.matmul(512, 512, 512, "bfloat16")
    target = W.matmul(512, 512, 640, "bfloat16")
    runner = AnalyticRunner(V5E)
    db = TuningDatabase()
    assert tune(prior, V5E, runner, trials=24, seed=0,
                database=db).warm_started == 0
    res = TuningSession(V5E, runner, database=db).tune_model(
        [(1, target)], total_trials=8, seed=1)
    rep = res.reports[0]
    assert rep.warm_started >= 1
    carried = min(runner.run(target, s)
                  for s in db.transfer_candidates(target, V5E.name))
    assert rep.best_latency <= carried + 1e-15


def test_session_multi_op_emulate_end_to_end(tmp_path):
    """A multi-op model tuned through EmulateRunner (the plain kernels on
    the host), deduped, database-backed."""
    wl_mm = W.matmul(16, 16, 16, "float32")
    wl_vm = W.vmacc(16, 16)
    ops = [(2, wl_mm), (1, wl_vm), (1, wl_mm)]
    db = TuningDatabase(str(tmp_path / "db.json"))
    runner = EmulateRunner(CPU_EMULATE, repeats=1, warmup=0)
    res = TuningSession(CPU_EMULATE, runner, database=db,
                        min_trials=3).tune_model(ops, total_trials=6, seed=0)
    assert len(res.reports) == 2 and res.reports[0].count == 3
    for rep in res.reports:
        assert math.isfinite(rep.best_latency) and rep.best_latency > 0
        assert rep.best_schedule is not None
    assert db.best(wl_mm, CPU_EMULATE.name) is not None
    assert db.sessions and db.sessions[0]["runner"] == "emulate"


def test_ensure_tuned_fills_only_missing(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    covered = W.matmul(128, 128, 128, "bfloat16")
    missing = W.vmacc(64, 128)
    tune(covered, V5E, AnalyticRunner(V5E), trials=8, seed=0, database=db)
    n_before = len(db.history(covered, V5E.name))
    res = ensure_tuned([(1, covered), (2, missing)], hw=V5E, database=db,
                       trials_per_workload=8)
    assert res is not None and res.runner_name == "analytic"
    assert [r.workload for r in res.reports] == [missing]
    assert db.best(missing, V5E.name) is not None
    assert len(db.history(covered, V5E.name)) == n_before
    assert ensure_tuned([(1, covered), (2, missing)], hw=V5E,
                        database=db) is None


def test_ensure_tuned_defaults_to_the_card_for_a_cuda_config():
    """For the H100 configuration the default runner is ``CudaRunner``:
    without a card it raises instead of falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError):
        ensure_tuned([(1, W.gemv(64, 64, "bfloat16"))], hw=H100,
                     database=TuningDatabase(), trials_per_workload=4)


def test_tune_warm_start_counts_toward_trials():
    wl = W.matmul(256, 512, 512, "bfloat16")
    runner = AnalyticRunner(V5E)
    seed_schedule = fixed_library_schedule(wl, V5E)
    res = tune(wl, V5E, runner, trials=8, seed=0, warm_start=[seed_schedule])
    assert res.warm_started == 1 and res.trials == 8
    assert res.history[0][0] == seed_schedule
    assert res.best_latency <= runner.run(wl, seed_schedule)


# ------------------------------------------------- interleaved sessions ----

def test_interleaved_session_matches_serial_per_workload_trajectories():
    ops = [(1, W.matmul(128, 128, 128, "bfloat16")), (2, W.vmacc(64, 256))]
    serial = TuningSession(V5E, AnalyticRunner(V5E),
                           database=TuningDatabase()).tune_model(
        ops, total_trials=16, seed=0)
    inter = TuningSession(V5E, SlowAnalytic(V5E), database=TuningDatabase(),
                          interleave=True).tune_model(
        ops, total_trials=16, seed=0)
    assert not serial.interleaved and inter.interleaved
    for a, b in zip(serial.reports, inter.reports):
        assert a.best_schedule == b.best_schedule
        assert a.best_latency == b.best_latency
        assert a.trials == b.trials


def test_interleaved_session_overlaps_measurement_with_search():
    ops = [(1, WL_A), (1, WL_B), (1, WL_C)]
    res = TuningSession(V5E, SlowAnalytic(V5E), interleave=True).tune_model(
        ops, total_trials=24, seed=0)
    assert res.measure_time_s > 0
    assert res.overlap_s > 0
    assert 0 < res.overlap_fraction <= 1
    assert res.summary()["overlap_fraction"] > 0


def test_interleaved_session_is_deterministic():
    ops = [(1, WL_A), (2, WL_B)]
    runs = [TuningSession(V5E, SlowAnalytic(V5E), interleave=True,
                          pipeline_depth=2).tune_model(ops, total_trials=16,
                                                       seed=4)
            for _ in range(2)]
    for a, b in zip(runs[0].reports, runs[1].reports):
        assert a.best_schedule == b.best_schedule
        assert a.best_latency == b.best_latency


def test_analytic_session_defaults_to_serial():
    ops = [(1, W.matmul(64, 64, 64, "bfloat16")), (1, W.vmacc(32, 64))]
    res = TuningSession(V5E, AnalyticRunner(V5E)).tune_model(
        ops, total_trials=8, seed=0)
    assert not res.interleaved and res.overlap_s == 0.0


def test_interleaved_emulate_session_on_a_small_network(tmp_path):
    """Keyword spotting (MLPerf Tiny DS-CNN, int8: four unique workloads,
    qmatmul and vmacc) through the plain kernels on the host, interleaved
    at depth 2: deduped, every workload resolves "tuned" on the card's
    design space, with a recorded overlap."""
    ops = nets.keyword_spotting("int8")
    db = TuningDatabase(str(tmp_path / "db.json"))
    runner = EmulateRunner(CPU_EMULATE, repeats=1, warmup=0)
    res = TuningSession(CPU_EMULATE, runner, database=db, min_trials=3,
                        pipeline_depth=2).tune_model(ops, total_trials=12,
                                                     seed=0)
    assert res.interleaved and res.pipeline_depth == 2
    assert len(res.reports) == len(dedup_workloads(ops)) == 4
    assert {r.workload.op for r in res.reports} == {"qmatmul", "vmacc"}
    for rep in res.reports:
        assert math.isfinite(rep.best_latency) and rep.best_latency > 0
        _, provenance = kernel_params(rep.workload, CPU_EMULATE, database=db)
        assert provenance == "tuned"
    assert res.overlap_fraction > 0
    assert db.sessions and db.sessions[0]["interleaved"] is True


# ------------------------------------------- pipelined (async) tune loop ----

def test_async_tune_bit_identical_to_sync_on_analytic():
    wl = W.matmul(256, 1024, 512, "bfloat16")
    sync = tune(wl, V5E, AnalyticRunner(V5E), trials=24, seed=7)
    piped = tune(wl, V5E, AnalyticRunner(V5E), trials=24, seed=7,
                 pipeline_depth=4)
    assert piped.pipeline_depth == 1
    assert piped.best_schedule == sync.best_schedule
    assert piped.best_latency == sync.best_latency
    assert piped.history == sync.history
    assert piped.overlap_s == 0.0


def test_async_tune_writes_same_database_records(tmp_path):
    db_sync = TuningDatabase(str(tmp_path / "sync.json"))
    db_async = TuningDatabase(str(tmp_path / "async.json"))
    wl = W.vmacc(256, 512)
    tune(wl, V5E, AnalyticRunner(V5E), trials=12, seed=0, database=db_sync)
    tune(wl, V5E, AnalyticRunner(V5E), trials=12, seed=0, database=db_async,
         pipeline_depth=3)
    assert db_sync.history(wl, V5E.name) == db_async.history(wl, V5E.name)


def test_speculative_pipeline_replays_deterministically():
    wl = W.matmul(512, 512, 512, "bfloat16")
    r1, r2 = (tune(wl, V5E, SlowAnalytic(V5E, 0.01), trials=16, seed=3,
                   pipeline_depth=3) for _ in range(2))
    assert r1.pipeline_depth == 3
    assert r1.history == r2.history
    assert r1.best_schedule == r2.best_schedule
    assert r1.trials == 16


def test_speculative_pipeline_overlaps_and_stays_competitive():
    wl = W.matmul(512, 2048, 2048, "bfloat16")
    res = tune(wl, V5E, SlowAnalytic(V5E, 0.02), trials=24, seed=0,
               pipeline_depth=3)
    assert res.measure_time_s > 0 and res.overlap_s > 0
    assert 0 < res.overlap_fraction <= 1
    fixed = AnalyticRunner(V5E).run(wl, fixed_library_schedule(wl, V5E))
    assert res.best_latency <= fixed and math.isfinite(res.best_latency)


def test_sync_tune_reports_zero_overlap():
    res = tune(W.matmul(256, 256, 256, "bfloat16"), V5E, AnalyticRunner(V5E),
               trials=12, seed=0)
    assert res.pipeline_depth == 1
    assert res.overlap_s == 0.0 and res.overlap_fraction == 0.0
    assert res.measure_time_s > 0


def test_warm_start_measured_first_in_pipelined_mode():
    wl = W.matmul(256, 512, 512, "bfloat16")
    seed_schedule = fixed_library_schedule(wl, V5E)
    res = tune(wl, V5E, SlowAnalytic(V5E, 0.005), trials=8, seed=0,
               warm_start=[seed_schedule], pipeline_depth=2)
    assert res.warm_started == 1 and res.trials == 8
    assert res.history[0][0] == seed_schedule


def test_emulate_pipelined_tune_overlaps():
    """The plain kernels on the host behind the scheduler's measurement
    thread: depth 2 is kept (overlap-capable, one slot) and some
    measurement hides behind the search."""
    wl = W.matmul(64, 64, 256, "float32")
    runner = EmulateRunner(CPU_EMULATE, repeats=3, warmup=1)
    assert tuner_lib.effective_pipeline_depth(runner, 2) == 2
    assert tuner_lib.effective_pipeline_depth(runner, 8) == 2
    # several batches, so that one is measured while the next evolves
    res = tune(wl, CPU_EMULATE, runner, trials=12, seed=0, batch=4,
               pipeline_depth=2)
    assert res.pipeline_depth == 2
    assert math.isfinite(res.best_latency) and res.best_latency > 0
    assert res.overlap_fraction > 0


# ------------------------------------------------------- scheduler basics ----

def test_serial_queue_wraps_sync_runner_bit_identically():
    runner = AnalyticRunner(V5E)
    schedules = _schedules(WL_A, 6)
    q = SerialMeasureQueue(runner)
    try:
        t1 = q.submit_batch(WL_A, schedules[:3])
        t2 = q.submit_batch(WL_A, schedules[3:])
        assert t1.result() == runner.run_batch(WL_A, schedules[:3])
        assert t2.result() == runner.run_batch(WL_A, schedules[3:])
        assert t1.measure_s >= 0 and t1.interval() is not None
    finally:
        q.close()


def test_serial_queue_reraises_a_fault_in_the_caller():
    """A fault raised by the runner on the measurement thread fails the
    ticket: ``result()`` re-raises it in the thread that waits."""
    class Faulty:
        name, hw = "faulty", V5E

        def run_batch(self, workload, schedules):
            raise RuntimeError("illegal memory access")

    q = SerialMeasureQueue(Faulty())
    try:
        ticket = q.submit_batch(WL_A, _schedules(WL_A, 1))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            ticket.result(timeout=10.0)
    finally:
        q.close()


def test_scheduler_preserves_per_key_fifo_order():
    sched = MeasureScheduler(SlowAnalytic(V5E, 0.005))
    try:
        a1 = _schedules(WL_A, 2)
        a2 = _schedules(WL_A, 2, seed=1)
        sched.submit("a", WL_A, a1)
        sched.submit("a", WL_A, a2)
        key1, batch1, lats1, _, _ = sched.collect_next()
        key2, batch2, _, _, _ = sched.collect_next()
        assert key1 == key2 == "a"
        assert [s.signature() for s in batch1] == [s.signature() for s in a1]
        assert [s.signature() for s in batch2] == [s.signature() for s in a2]
        assert lats1 == AnalyticRunner(V5E).run_batch(WL_A, a1)
    finally:
        sched.close()


def test_scheduler_collects_completed_ticket_before_blocked_head():
    """Completion-aware collection on a native async backend: a finished
    batch of another key is handed back before the blocked oldest one."""
    runner = ThreadedAsyncRunner(V5E, delays_s=(0.3, 0.0))
    sched = MeasureScheduler(runner)
    try:
        assert sched.multi_queue
        sched.submit("slow", WL_A, _schedules(WL_A, 1))
        sched.submit("fast", WL_A, _schedules(WL_A, 1, seed=1))
        t0 = time.monotonic()
        key, _, _, _, _ = sched.collect_next()
        assert key == "fast" and time.monotonic() - t0 < 0.25
        assert sched.collect_next()[0] == "slow"
    finally:
        sched.close()


def test_scheduler_overlap_is_span_accurate():
    sched = MeasureScheduler(SlowAnalytic(V5E, 0.02))
    try:
        sched.submit(0, WL_A, _schedules(WL_A, 2))
        sched.collect_next()
        assert sched.measure_span_s() > 0
        assert sched.overlap_s() <= 0.005
        sched.submit(0, WL_A, _schedules(WL_A, 2, seed=1))
        time.sleep(0.015)
        sched.collect_next()
        assert sched.overlap_s() > 0.005
        assert sched.overlap_s() <= sched.measure_span_s() + 1e-9
    finally:
        sched.close()


def test_max_inflight_hints():
    assert MeasureScheduler(AnalyticRunner(V5E)).max_inflight == 1
    runner = ThreadedAsyncRunner(V5E)
    assert MeasureScheduler(runner).max_inflight == 3
    forced = MeasureScheduler(runner, multi_queue=False)
    assert not forced.multi_queue and forced.max_inflight == 1
    forced.close()


def _run_drivers(runner, seed, multi_queue, depth=1):
    drivers = [tuner_lib.TuneDriver(wl, V5E, runner, trials=6, seed=seed + i,
                                    batch=3)
               for i, wl in enumerate((WL_A, WL_B, WL_C))]
    tuner_lib.run_scheduled(drivers, runner, depth, multi_queue=multi_queue)
    return drivers


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 5), depth=st.integers(1, 2),
       delays=st.lists(st.sampled_from([0.0, 0.001, 0.003]), min_size=2,
                       max_size=3))
def test_property_multi_queue_histories_replay_single_fifo(seed, depth,
                                                           delays):
    """Batches of every driver in flight at once on an async backend that
    completes them out of order: per-driver histories equal the
    single-FIFO measurement thread's, bit for bit."""
    fifo = _run_drivers(ThreadedAsyncRunner(V5E, delays), seed, False, depth)
    multi = _run_drivers(ThreadedAsyncRunner(V5E, delays), seed, True, depth)
    for a, b in zip(fifo, multi):
        assert a.history == b.history
        assert a.best_schedule == b.best_schedule
        assert a.best_latency == b.best_latency


class _RecordingAsyncRunner:
    """Async-protocol runner that records every submission and completes
    tickets instantly with analytic latencies."""

    overlap_capable = True
    max_inflight = 4
    name = "recording-async"

    def __init__(self, hw):
        self.hw = hw
        self._inner = AnalyticRunner(hw)
        self.submissions: list[tuple[str, int]] = []

    def run(self, workload, schedule):
        return self._inner.run(workload, schedule)

    def run_batch(self, workload, schedules):
        return self._inner.run_batch(workload, schedules)

    def submit_batch(self, workload, schedules):
        self.submissions.append((workload.key(), len(schedules)))
        ticket = MeasureTicket(workload, schedules)
        ticket._complete(self._inner.run_batch(workload, schedules))
        return ticket


def test_session_baselines_submitted_as_one_wave():
    runner = _RecordingAsyncRunner(V5E)
    ops = [(1, WL_A), (2, WL_B), (1, WL_C)]
    res = TuningSession(V5E, runner, database=TuningDatabase()).tune_model(
        ops, total_trials=12, seed=0)
    tail = runner.submissions[-3:]
    assert [n for _, n in tail] == [1, 1, 1]
    assert [k for k, _ in tail] == [WL_A.key(), WL_B.key(), WL_C.key()]
    for rep in res.reports:
        fixed = AnalyticRunner(V5E).run(
            rep.workload, fixed_library_schedule(rep.workload, V5E))
        assert rep.fixed_latency == fixed or not math.isfinite(fixed)


def test_session_summary_carries_span_and_queue_mode():
    runner = ThreadedAsyncRunner(V5E, delays_s=(0.002, 0.001))
    res = TuningSession(V5E, runner, database=TuningDatabase()).tune_model(
        [(1, WL_A), (1, WL_B)], total_trials=8, seed=0)
    summary = res.summary()
    assert summary["multi_queue"] is True
    assert summary["measure_span_s"] > 0
    assert summary["board_stats"] is None and summary["preemptions"] == 0
    assert res.measure_span_s <= res.measure_time_s + 1e-9


# -------------------------------------------------- wall-time attribution ----

def test_driver_wall_time_excludes_construction_gap():
    runner = AnalyticRunner(V5E)
    driver = tuner_lib.TuneDriver(WL_B, V5E, runner, trials=6, seed=0)
    time.sleep(0.25)
    t0 = time.perf_counter()
    while (batch := driver.propose()) is not None:
        driver.reconcile(batch, runner.run_batch(WL_B, batch))
    active = time.perf_counter() - t0
    res = driver.finish()
    assert res.wall_time_s <= active + 0.05 and res.wall_time_s < 0.2


def test_interleaved_drivers_attribute_only_their_own_span():
    runner = SlowAnalytic(V5E, 0.002)
    drivers = [tuner_lib.TuneDriver(wl, V5E, runner, trials=4, seed=i,
                                    batch=2)
               for i, wl in enumerate((WL_A, WL_B))]
    time.sleep(0.25)
    t0 = time.perf_counter()
    tuner_lib.run_scheduled(drivers, runner, depth=1)
    driving = time.perf_counter() - t0
    for d in drivers:
        assert d.finish().wall_time_s <= driving + 0.05


def test_never_driven_driver_reports_zero_wall_time():
    driver = tuner_lib.TuneDriver(WL_B, V5E, AnalyticRunner(V5E), trials=4)
    assert driver.finish().wall_time_s == 0.0


# ------------------------------------------------- adaptation (scheduler) ----

class _ScriptedScheduler:
    def __init__(self, busy=0.0, max_inflight=4):
        self.busy = busy
        self.max_inflight = max_inflight

    def busy_fraction(self, window_s=2.0):
        return self.busy


def test_depth_policy_grows_holds_shrinks_and_caps():
    pol = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1)
    for _ in range(6):
        pol.on_collect("k", _ScriptedScheduler(busy=0.2), lag=0)
    assert pol.depth("k") == 4 and [d for _, _, d in pol.events] == [2, 3, 4]
    assert pol.depth("other") == 1
    held = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1)
    for _ in range(6):
        held.on_collect("k", _ScriptedScheduler(busy=0.95), lag=0)
    assert held.depth("k") == 1 and not held.events
    lag = AdaptiveDepthPolicy(1, max_depth=4, cooldown=1, lag_threshold=2.0)
    idle = _ScriptedScheduler(busy=0.0)
    for _ in range(4):
        lag.on_collect("k", idle, lag=0)
    for _ in range(40):
        lag.on_collect("k", idle, lag=30)
    assert lag.depth("k") == 1
    capped = AdaptiveDepthPolicy(1, max_depth=8, cooldown=1)
    for _ in range(10):
        capped.on_collect("k", _ScriptedScheduler(max_inflight=2), lag=0)
    assert capped.depth("k") == 3


def test_effective_depth_clamps():
    assert tuner_lib.effective_pipeline_depth(SlowAnalytic(V5E), 3) == 3
    assert tuner_lib.effective_pipeline_depth(AnalyticRunner(V5E), 5) == 1
    assert tuner_lib.effective_pipeline_depth(ThreadedAsyncRunner(V5E),
                                              8) == 4
    sync = tune(WL_B, V5E, AnalyticRunner(V5E), trials=4, seed=0,
                pipeline_depth=4)
    assert sync.pipeline_depth == 1 and sync.depth_trace == [(0, 1)]


def test_adaptive_tune_records_depth_growth():
    runner = ThreadedAsyncRunner(V5E, delays_s=(0.01, 0.02, 0.03, 0.04))
    res = tune(W.matmul(256, 512, 512, "bfloat16"), V5E, runner, trials=16,
               seed=0, batch=2, pipeline_depth=2, adaptive_depth=True,
               max_depth=4)
    assert res.depth_trace[0] == (0, 2)
    assert max(d for _, d in res.depth_trace) > 2


def test_budget_ledger_caps_grants_by_fraction():
    ledger = BudgetLedger(reallocate_fraction=0.5)
    ledger.release(40)
    assert ledger.available == 20
    assert ledger.draw(8) == 8 and ledger.draw(100) == 12
    assert ledger.draw(1) == 0
    assert (ledger.released, ledger.granted) == (40, 20)


def test_entropy_session_spends_fewer_trials_at_equal_or_better_best():
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
    assert pol.stopped_early >= 1 and pol.released_trials > 0
    for a, b in zip(base.reports, pol.reports):
        assert b.best_latency <= a.best_latency * (1 + 1e-9)
    assert pol.summary()["stop_policy"] == "entropy"
    assert base.summary()["stop_policy"] == "none"


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


def test_entropy_stop_curtails_converged_and_grants_to_improving():
    ledger = BudgetLedger()
    stop = EntropyStopPolicy(ledger, entropy_threshold=0.9,
                             plateau_patience=5)
    converged = _FakeDriver(remaining=30, plateau=6,
                            entropy={"a": 0.5, "b": 0.7})
    stop(0, converged)
    assert converged.curtailed and ledger.released == 30 and stop.stops == 1
    stop(0, converged)   # stays stopped, releases nothing twice
    assert ledger.released == 30 and stop.stops == 1
    for spared in (_FakeDriver(remaining=30, plateau=2, entropy={"a": 0.5}),
                   _FakeDriver(remaining=30, plateau=9, entropy={"a": 0.99}),
                   _FakeDriver(remaining=30, plateau=9, entropy={})):
        stop(1, spared)
        assert not spared.curtailed
    plateaued = _FakeDriver(remaining=0, plateau=9, batch=8)
    improving = _FakeDriver(remaining=0, plateau=2, batch=8)
    stop(2, plateaued)
    stop(3, improving)
    assert plateaued.extended == 0 and improving.extended == 8
    assert ledger.granted == 8


def test_session_rejects_unknown_stop_policy():
    session = TuningSession(V5E, AnalyticRunner(V5E), stop_policy="magic")
    with pytest.raises(ValueError, match="stop_policy"):
        session.tune_model([(1, WL_B)], total_trials=4, seed=0)


# ----------------------------------------------- parity with the reference ----

def test_networks_and_decode_ops_match_reference():
    """The port's copy of the networks and ``decode_ops`` give the
    reference's workloads, counts and order."""
    names = [n for n in dir(ref_nets) if not n.startswith("_")
             and callable(getattr(ref_nets, n)) and n not in ("annotations",)
             and getattr(getattr(ref_nets, n), "__module__", "") ==
             ref_nets.__name__]
    assert "mobilenetv2" in names and names == sorted(
        n for n in dir(nets) if not n.startswith("_")
        and getattr(getattr(nets, n), "__module__", "") == nets.__name__)
    for name in names:
        for dtype in ("int8", "float32", "bfloat16"):
            ours = [(c, wl.key()) for c, wl in getattr(nets, name)(dtype)]
            theirs = [(c, wl.key()) for c, wl in getattr(ref_nets, name)(dtype)]
            assert ours == theirs, (name, dtype)
    for batch in (1, 4):
        ours = decode_ops(get_config("mobilellm_125m"), batch)
        theirs = ref_decode_ops(ref_get_config("mobilellm_125m"), batch)
        assert [(c, wl.key()) for c, wl in ours] == \
            [(c, wl.key()) for c, wl in theirs]
    assert [wl.op for _, wl in decode_ops(get_config("mobilellm_125m"),
                                          1)] == ["gemv"] * 5


def test_configs_match_reference_field_by_field():
    ours, theirs = get_config("mobilellm_125m"), ref_get_config(
        "mobilellm_125m")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    for attr in ("q_dim", "kv_dim", "padded_vocab"):
        assert getattr(ours, attr) == getattr(theirs, attr)


@pytest.mark.parametrize("depth", [1, 2], ids=["serial", "interleaved-d2"])
def test_mobilenetv2_session_bit_identical_to_reference(depth):
    """MobileNetV2 int8 (24 unique workloads) tuned by both packages from
    seed 0 on ``V5E``: the same per-workload histories (the database
    records, in measurement order), best schedules, latencies and fixed
    baselines. Depth 1 runs the serial analytic path; depth 2 runs the
    interleaved path, each package behind its own slow runner."""
    if depth == 1:
        runner, ref_runner = AnalyticRunner(V5E), RefAnalytic(REF_V5E)
    else:
        runner, ref_runner = (SlowAnalytic(V5E, 0.0005),
                              RefSlowAnalytic(REF_V5E, 0.0005))
    db, ref_db = TuningDatabase(), RefDatabase()
    ours = TuningSession(V5E, runner, database=db,
                         pipeline_depth=depth).tune_model(
        nets.mobilenetv2("int8"), total_trials=96, seed=0)
    theirs = RefSession(REF_V5E, ref_runner, database=ref_db,
                        pipeline_depth=depth).tune_model(
        ref_nets.mobilenetv2("int8"), total_trials=96, seed=0)
    assert ours.interleaved is theirs.interleaved is (depth == 2)
    assert ours.pipeline_depth == theirs.pipeline_depth == depth
    assert len(ours.reports) == 24
    assert _report_rows(ours) == _report_rows(theirs)
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert json.dumps(db.distributions) == json.dumps(ref_db.distributions)
    assert ours.tuned_latency == theirs.tuned_latency
    assert ours.fixed_latency == theirs.fixed_latency
