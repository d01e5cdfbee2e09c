"""The port's tracer (``repro_torch.tracing``) and the spans and counters the
port records with it.

- Off, ``span`` hands back the shared no-op, reads no clock and records
  nothing; on, spans nest by thread, a ``cpu`` span splits its thread's
  CPU time from the rest, and counters add exactly under contention.
- The launch counters keep ``kernels.launch_counts()``'s results.
- A span brackets the profiler's host event of the op inside it: the two
  share one clock; a profiler alone records no span.
- A fixed-seed session on the emulate runner reconciles the same history
  with the tracer on and off, and on it records every span of set-up, the
  search and measure spans of one batch sharing its id; the session's
  search and measure times hold its spans.
"""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import kernels, tracing  # noqa: E402
from repro_torch.core import (CPU_EMULATE, AnalyticRunner,  # noqa: E402
                              EmulateRunner, TuningDatabase, TuningSession)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.build_cache import global_build_cache  # noqa: E402
from repro_torch.core.runner import INVALID  # noqa: E402


@pytest.fixture
def recording():
    """Recording on for the test, and off with nothing left after it."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


def test_off_hands_back_the_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while tracing was off")

    monkeypatch.setattr(tracing, "_now", no_clock)
    monkeypatch.setattr(tracing, "_cpu", no_clock)
    first = tracing.span("a", k=1)
    assert first is tracing.OFF and tracing.span("b") is first
    with tracing.span("c", cpu=True):
        with tracing.span("d"):
            pass
    assert tracing.collect() == []


def test_spans_nest_on_their_own_thread(recording):
    def worker():
        with tracing.span("c"):
            with tracing.span("d", batch=(0, 1)):
                pass

    with tracing.span("a"):
        with tracing.span("b"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=10)
    assert not thread.is_alive()
    by = {s.name: s for s in tracing.collect()}
    assert set(by) == {"a", "b", "c", "d"}
    assert by["a"].parent is None and by["b"].parent == by["a"].id
    assert by["c"].parent is None and by["d"].parent == by["c"].id
    assert by["a"].thread == by["b"].thread != by["c"].thread == \
        by["d"].thread
    assert by["d"].attrs == {"batch": (0, 1)}
    for outer, inner in (("a", "b"), ("b", "c"), ("c", "d")):
        assert by[outer].start_ns <= by[inner].start_ns \
            <= by[inner].end_ns <= by[outer].end_ns


def test_spans_and_counters_hold_under_contention(recording):
    """More threads than cores, switching every microsecond: every span's
    parent is open on its own thread, and no count is lost."""
    threads, rounds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(rounds):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("test.contention")

        before = tracing.counters().get("test.contention", 0)
        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert tracing.counters()["test.contention"] - before == threads * rounds
    recorded = tracing.collect()
    assert len(recorded) == 2 * threads * rounds
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
        else:
            assert s.parent is None


def test_a_cpu_span_splits_its_threads_work_from_the_rest(recording):
    """A span opened with ``cpu=True`` holds its thread's CPU time: all of
    a busy loop, little of a sleep; a span without it holds None."""
    with tracing.span("busy", cpu=True):
        end = time.thread_time_ns() + 20_000_000
        while time.thread_time_ns() < end:
            pass
    with tracing.span("asleep", cpu=True):
        time.sleep(0.05)
    with tracing.span("plain"):
        pass
    by = {s.name: s for s in tracing.collect()}
    busy, asleep = by["busy"], by["asleep"]
    assert 20_000_000 <= busy.cpu_ns <= busy.end_ns - busy.start_ns
    assert 0 <= asleep.cpu_ns <= 0.2 * (asleep.end_ns - asleep.start_ns)
    assert by["plain"].cpu_ns is None


def test_counters_and_launch_counts():
    tracing.count("test.a")
    tracing.count("test.a", 4)
    tracing.count("test.b", 2)
    counted = tracing.counters()
    assert counted["test.a"] >= 5 and counted["test.b"] >= 2
    tracing.reset_counters("test.")
    assert tracing.counters()["test.a"] == tracing.counters()["test.b"] == 0

    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_NAMES, 0)
    tracing.count("launch._qmm_kernel", 3)
    assert kernels.launch_counts()["_qmm_kernel"] == 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_span_clock_brackets_the_profilers_event(recording):
    """``time.time_ns()`` is the clock of the profiler's host events: a span
    around an op starts before its event starts and ends after it ends."""
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.ones(4096), torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracing.span("add"):
                torch.add(a, b)
    spans = [s for s in tracing.collect() if s.name == "add"]
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::add")
    assert len(spans) == len(events) == 5
    for s, (start, end) in zip(sorted(spans, key=lambda s: s.start_ns),
                               events):
        assert s.start_ns <= start <= end <= s.end_ns


def test_spans_record_while_the_profiler_records():
    """Inside a profiled region a span records only while recording is
    enabled: the profiler alone records none."""
    from torch.profiler import ProfilerActivity, profile

    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled"):
            pass
        tracing.enable()
        try:
            with tracing.span("enabled"):
                pass
        finally:
            tracing.disable()
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.collect()] == ["enabled"]


class DeterministicEmulate(EmulateRunner):
    """The emulate runner, building and running each candidate as it does,
    but reporting the analytic model's latency: a history that repeats."""

    def run(self, workload, schedule):
        if super().run(workload, schedule) == INVALID:
            return INVALID
        return AnalyticRunner(self.hw).run(workload, schedule)


OPS = [(2, W.matmul(64, 64, 64, "float32")), (1, W.vmacc(64, 128))]


def session_history(trace: bool):
    # every candidate built afresh: its build is a span
    global_build_cache().clear()
    db = TuningDatabase()
    runner = DeterministicEmulate(CPU_EMULATE, repeats=1, warmup=1)
    if trace:
        tracing.enable()
    try:
        result = TuningSession(CPU_EMULATE, runner, database=db,
                               pipeline_depth=2, min_trials=8).tune_model(
            OPS, total_trials=48, seed=3, model="tiny")
    finally:
        tracing.disable()
    history = [(rec["schedule"], rec["latency_s"])
               for _, wl in OPS for rec in db.history(wl, CPU_EMULATE.name)]
    return result, history, tracing.collect()


def test_fixed_seed_history_is_the_same_with_the_tracer_on():
    tracing.collect()
    result_off, off, none = session_history(trace=False)
    result_on, on, recorded = session_history(trace=True)
    assert none == [] and on == off and len(on) == 48
    assert [r.best_latency for r in result_on.reports] == \
        [r.best_latency for r in result_off.reports]
    names = {s.name for s in recorded}
    assert {"session.baselines", "static_analysis.feasibility",
            "tuner.sample", "tuner.evolve", "cost_model.refit",
            "measure_scheduler.batch", "runner.measure", "space.concretize",
            "kernels.build", "runner.first_run", "matmul.call",
            "vmacc.call"} <= names
    # one batch's search on the tuning thread and its measurement on the
    # measuring thread, named by one id
    searched: dict = {}
    for s in recorded:
        if s.name in ("tuner.sample", "tuner.evolve"):
            searched.setdefault(s.attrs["batch"], []).append(s)
    measured = {s.attrs["batch"]: s for s in recorded
                if s.name == "measure_scheduler.batch"
                and s.attrs["batch"] is not None}
    assert measured and set(measured) <= set(searched)
    for batch, m in measured.items():
        for s in searched[batch]:
            assert s.thread != m.thread and s.end_ns <= m.start_ns
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.name in ("kernels.build", "space.concretize",
                      "runner.first_run"):
            assert by_id[s.parent].name == "runner.measure"
        if s.name == "runner.measure" and s.parent is not None:
            assert by_id[s.parent].name == "measure_scheduler.batch"
        if s.name in ("runner.measure", "runner.first_run", "tuner.sample",
                      "tuner.evolve", "measure_scheduler.batch"):
            assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns + 1e6


def test_trials_and_invalid_counted_per_reconciled_candidate():
    before = tracing.counters()
    result, history, _ = session_history(trace=False)
    after = tracing.counters()
    assert after["tuner.trials"] - before.get("tuner.trials", 0) == \
        result.total_trials == len(history)


def test_session_timings_agree_with_its_spans():
    """What the benchmark reads of a session (its search and measure
    times) holds its spans: the search's sampling and evolution, and the
    measuring thread's batches."""
    tracing.collect()
    result, _, recorded = session_history(trace=True)

    def total(name, keep=lambda s: True):
        return sum(s.end_ns - s.start_ns for s in recorded
                   if s.name == name and keep(s)) / 1e9

    searched = total("tuner.sample") + total("tuner.evolve")
    assert 0 < searched <= result.search_time_s
    # the search's batches, not the baselines' (which carry no batch id)
    measured = total("measure_scheduler.batch",
                     lambda s: s.attrs["batch"] is not None)
    assert result.measure_time_s == pytest.approx(measured, rel=0.02,
                                                  abs=1e-3)


def test_session_span_lasts_as_long_as_the_session():
    """The session's spans lie within the session's own wall time
    (``tune_s``), which lies within its caller's."""
    tracing.collect()
    t0 = time.perf_counter()
    result, _, recorded = session_history(trace=True)
    outside = time.perf_counter() - t0
    extent = (max(s.end_ns for s in recorded)
              - min(s.start_ns for s in recorded)) / 1e9
    assert extent <= result.wall_time_s <= outside
