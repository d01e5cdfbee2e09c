"""The readers of the program's timings and counters (``metrics/tune_s.py``,
``search_ms_per_trial.py``, ``measure_ms_per_trial.py``) and the span
report (``spans.py``): a traced run of the tiny cell on the CPU reads all
three, the trials from the program's ``tuner.trials`` counter, and records
no span (the tracer stays off); a program without the tracer reads
``tune_s`` alone; the report splits the tiny cell's set-up by part and by
span and its passes by the wrappers' spans, and the idle it sets inside
the wrappers' spans lies within the window's idle on a trace made up for
the purpose. On a card (``-m gpu``): a ``qmatmul.launch`` span holds its
runtime call on the profiler's timeline and starts before its kernel, a
traced run of each cell prints the three, and the report runs on a
cell."""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness, spans
from portbench.loops import passes
from portbench.metrics import idle_share
from portbench.test_portbench_faults import MIX, TINY
from portbench.trace import Trace
import repro_torch
from repro_torch import tracing
from repro_torch.core.runner import EmulateRunner

E2E = ["infer_ms", "infer_p95_ms", "setup_s"]
NEW = ["tune_s", "search_ms_per_trial", "measure_ms_per_trial"]


def tiny_context(seed=2**31 + 7):
    torch.set_num_threads(1)
    cell = harness.Cell(name="tiny.infer", config=TINY,
                        traffic=dict(MIX, rotate_bytes=0), chips=1,
                        units=dict.fromkeys(E2E + NEW, "-"), end_to_end=E2E,
                        per_layer=NEW)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.05, trace=True,
                          device="cpu", t0=time.perf_counter(),
                          runner_class=EmulateRunner)
    return ctx, cell


def traced_run(seed=2**31 + 7):
    """The tiny cell's loop, traced, in a process whose trials counter
    starts at zero, as a benchmark run's does: (run, cell)."""
    ctx, cell = tiny_context(seed)
    tracing.reset_counters("tuner.")
    return passes.run(ctx), cell


def test_traced_run_reads_every_program_metric():
    tracing.collect()
    run, cell = traced_run()
    values = harness.read_per_layer(cell, run)
    assert set(values) == set(NEW)
    assert all(v > 0 for v in values.values())
    session = run.facts["session"]
    trials = tracing.counters()["tuner.trials"]
    assert trials == session.total_trials
    assert values["tune_s"] == session.wall_time_s
    assert values["search_ms_per_trial"] == pytest.approx(
        1e3 * session.search_time_s / trials)
    assert values["measure_ms_per_trial"] == pytest.approx(
        1e3 * session.measure_time_s / trials)
    # the tracer stays off in a benchmark run: the profiled window records
    # no span
    assert tracing.collect() == []


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    run, cell = traced_run()
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    session = run.facts["session"]
    older = types.SimpleNamespace(
        wall_time_s=session.wall_time_s, total_trials=session.total_trials,
        measure_time_s=session.measure_time_s)
    run = dataclasses.replace(run, facts={"session": older})
    values = harness.read_per_layer(cell, run)
    assert set(values) == {"tune_s"}


def test_span_report_splits_the_tiny_cells_set_up_and_passes():
    ctx, _ = tiny_context()
    report, launches = spans.setup(ctx)
    assert list(report["parts"]) == ["cuda_context", "operands", "session",
                                     "resolve", "warm_up"]
    assert report["parts"]["session"] >= report["session_wall_s"] > 0
    assert report["trials"] == 4 * len({(o["op"], tuple(o["dims"]))
                                        for o in TINY["ops"]})
    session = report["session"]
    for name in ("main: tuner.sample",
                 "other: measure_scheduler.batch", "other: runner.measure",
                 "other: runner.first_run"):
        assert session[name]["n"] > 0 and session[name]["cpu_s"] >= 0
    assert "main: dispatch.kernel_params" in report["resolve_and_warm_up"]
    split = spans.passes_split(ctx, launches, blocks=2, block_passes=2)
    assert set(split) == {"off", "on"}
    assert split["on"]["calls"] == 2 * sum(o["count"] for o in TINY["ops"])
    assert split["on"]["launch_host_us"] > 0
    # on the CPU the card is never busy: every call lies in idle time
    assert split["on"]["idle_in_call_pct"] <= split["on"]["idle_pct"]
    assert tracing.collect() == []


def call(start, end, name="qmatmul.call"):
    return (start, end, name)


@pytest.mark.parametrize("calls", [
    [],
    [call(0, 1000)],
    [call(100, 200), call(250, 900, "vmacc.call"), call(880, 990)],
    [call(-50, 40), call(300, 700, "vmacc.launch")],
])
def test_idle_inside_calls_lies_within_idle_share(calls):
    """Window 0-1000 ns; the card busy 200-300 and 600-800: idle 700 ns.
    The report's idle inside the wrappers' calls is at most all of it,
    and all of it where a call covers the window."""
    trace = Trace((0, 1000), [(200, 300, "k"), (600, 800, "k")], [])
    run = harness.Run(attempted=1, end_to_end={}, answers=[],
                      expected_answers=0, memory_peak_bytes=0, trace=trace)
    idle = idle_share.read(run, None)
    assert idle == pytest.approx(70.0)
    inside = [(a, b) for a, b, name in calls if name in spans.CALLS]
    wrapped = 100.0 * spans.overlap_ns(trace.idle_gaps(), inside) / 1e9 \
        / trace.window_s
    assert 0.0 <= wrapped <= idle
    clipped = [(max(a, 0), min(b, 1000)) for a, b in inside]
    busy = [(200, 300), (600, 800)]
    assert wrapped == pytest.approx(
        100.0 * (sum(b - a for a, b in spans.merged(clipped))
                 - spans.overlap_ns(clipped, busy)) / 1000)
    full = spans.overlap_ns(trace.idle_gaps(), [(0, 1000)])
    assert 100.0 * full / 1000 == pytest.approx(idle)


def test_overlap_of_unions():
    assert spans.overlap_ns([(0, 10), (5, 20)], [(15, 30), (18, 19)]) == 5
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0
    assert spans.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


@pytest.mark.gpu
def test_launch_span_starts_before_its_kernel(card):
    """Recorded while the profiler records, each ``qmatmul.launch`` span
    holds its runtime call on the profiler's host timeline and starts
    before its kernel's interval on the card's."""
    from portbench import inputs, trace
    from portbench.reference import family
    from repro_torch import kernels
    from repro_torch.core.dispatch import fixed_library_schedule
    from repro_torch.core.hardware import H100
    from repro_torch.core.space import concretize

    op = {"op": "qmatmul", "dims": [1024, 64, 576], "dtype": "int8"}
    wl = inputs.workload(op)
    fn = kernels.build(wl, concretize(wl, H100,
                                      fixed_library_schedule(wl, H100)))
    args = family("qmatmul").inputs(
        op["dims"], op["dtype"], TINY["assumed"],
        inputs.generator(5, "cuda"), "cuda")
    fn(*args)
    torch.cuda.synchronize()
    ctx = types.SimpleNamespace(device="cuda", sync=torch.cuda.synchronize)
    holder: dict = {}
    tracing.collect()
    tracing.enable()
    try:
        with trace.traced(ctx, holder):
            for _ in range(5):
                fn(*args)
                torch.cuda.synchronize()
    finally:
        tracing.disable()
    launches = sorted((s for s in tracing.collect()
                       if s.name == "qmatmul.launch"),
                      key=lambda s: s.start_ns)
    traced = holder["trace"]
    ran = traced.operations(r"\bqmm_kernel\b")
    calls = sorted(h for h in traced.host if h[2].startswith("cudaLaunch"))
    assert len(launches) == len(ran) == len(calls) == 5
    for span, kernel, call in zip(launches, ran, calls):
        assert span.start_ns <= call[0] <= call[1] <= span.end_ns
        assert span.start_ns <= kernel[0]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_manifest()["workloads"]])
def test_traced_run_prints_the_program_metrics(card, cell):
    # the run needs the card's memory that this process's allocator may
    # still hold from an earlier test
    gc.collect()
    torch.cuda.empty_cache()
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"),
         "--workload", cell, "--seed", str(2**31 + 29), "--seconds", "1",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(metrics)
    assert all(metrics[name] > 0 for name in NEW)


@pytest.mark.gpu
def test_span_report_runs_on_a_cell(card):
    """The report on the smaller cell: set-up's parts cover it, and the
    passes' wrappers' spans lie in the recorded half."""
    gc.collect()
    torch.cuda.empty_cache()
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "spans.py"),
         "--workload", "resnet18-int8-b64.infer", "--seed", str(2**31 + 31),
         "--blocks", "1", "--block-passes", "5"], capture_output=True,
        text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert 0.9 * report["setup_s"] <= sum(report["parts"].values()) \
        <= report["setup_s"]
    assert report["passes"]["on"]["calls"] == 5 * 18
    assert report["passes"]["on"]["launch_span_us"] \
        < report["passes"]["on"]["launch_host_us"]
