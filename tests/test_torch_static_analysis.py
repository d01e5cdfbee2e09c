"""Static feasibility analyzer: parity with the dynamic postprocessors,
bit-identical searches when nothing prunes, database quarantine, and
farm/scheduler refusal of statically-invalid work.

The JAX package's ``tests/test_static_analysis.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import dataclasses
import json
import math
import sys

import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, st

from repro_torch.core import workload as W
from repro_torch.core import space as space_lib
from repro_torch.core import static_analysis as SA
from repro_torch.core.database import TuningDatabase
from repro_torch.core.board_farm import simulated_farm
from repro_torch.core.hardware import V5E, V5E_MXU256, V5E_VMEM32, V5E_VMEM64
from repro_torch.core.measure_scheduler import MeasureScheduler
from repro_torch.core.runner import INVALID, AnalyticRunner
from repro_torch.core.sampler import TraceSampler
from repro_torch.core.schedule import Schedule
from repro_torch.core.tuner import tune

ALL_HW = (V5E, V5E_VMEM32, V5E_VMEM64, V5E_MXU256)


def _dynamic_enumeration(prog):
    """Ground truth: every trace through concretize + postprocessors."""
    total = valid = 0
    feasible = {ins.name: set() for ins in prog.instructions}
    for t in prog.traces(limit=SA.DEFAULT_TRACE_LIMIT):
        total += 1
        if prog.validate(Schedule.fixed(**t)).valid:
            valid += 1
            for k, v in t.items():
                feasible[k].add(v)
    return total, valid, feasible


def _assert_parity(wl, hw):
    report = SA.analyze(wl, hw)
    assert report.exhaustive
    total, valid, feasible = _dynamic_enumeration(space_lib.space_for(wl, hw))
    assert (report.total_traces, report.valid_traces) == (total, valid)
    for name, vals in feasible.items():
        assert set(report.feasible[name]) == vals, name


# ------------------------------------------------- analyzer <-> postproc ----

@pytest.mark.parametrize("hw", ALL_HW, ids=lambda h: h.name)
@pytest.mark.parametrize("wl", [
    W.matmul(512, 512, 512, "bfloat16"),
    W.qmatmul(256, 256, 256),
    W.gemv(512, 2048, "bfloat16"),
    W.vmacc(256, 1024),
    W.attention(1, 8, 8, 256, 256, 128),
], ids=lambda w: w.op)
def test_analyzer_matches_dynamic_enumeration(wl, hw):
    _assert_parity(wl, hw)


@settings(max_examples=20, deadline=None)
@given(family=st.sampled_from(["matmul", "qmatmul", "gemv", "vmacc"]),
       d0=st.integers(min_value=1, max_value=12),
       d1=st.integers(min_value=1, max_value=12),
       d2=st.integers(min_value=1, max_value=12),
       hw_i=st.integers(min_value=0, max_value=len(ALL_HW) - 1))
def test_property_feasible_iff_postprocessor_valid(family, d0, d1, d2, hw_i):
    """Hypothesis property: on randomized shapes, for all four kernel
    families with generative splits, a (decision, value) pair is in the
    analyzer's feasible set iff it appears in some postprocessor-valid
    trace — and the trace counts agree exactly."""
    dims = tuple(x * 64 for x in (d0, d1, d2))
    wl = {"matmul": lambda: W.matmul(*dims, "bfloat16"),
          "qmatmul": lambda: W.qmatmul(*dims),
          "gemv": lambda: W.gemv(dims[0], dims[1], "float32"),
          "vmacc": lambda: W.vmacc(dims[0], dims[1])}[family]()
    _assert_parity(wl, ALL_HW[hw_i])


def test_analyzer_memoized_per_workload_hardware():
    wl = W.matmul(128, 128, 128, "bfloat16")
    assert SA.analyze(wl, V5E) is SA.analyze(wl, V5E)
    assert SA.analyze(wl, V5E) is not SA.analyze(wl, V5E_VMEM32)


def test_nonexhaustive_degrades_permissive():
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_lib.space_for(wl, V5E)
    report = SA.analyze(wl, V5E, program=prog, limit=3)
    assert not report.exhaustive
    assert report.is_feasible("variant", "definitely-not-a-variant")
    assert report.check_schedule(Schedule.fixed(variant="nope")) == ""
    # nothing is pruned on a truncated report's authority
    assert SA.pruned_program(prog, report) is prog


# ----------------------------------------------------------- diagnostics ----

def _with_extra_candidate(prog, name, extra):
    """The registered program with one bogus value injected into a
    decision's candidate set (a generator that ignores validity)."""
    ins = [dataclasses.replace(
        i, candidates=(lambda ctx, _o=i.candidates, _e=extra:
                       tuple(_o(ctx)) + (_e,)))
        if i.name == name else i for i in prog.instructions]
    return space_lib.SpaceProgram(prog.workload, prog.hw, ins,
                                  prog.postprocessors)


def test_dead_candidate_detected_in_custom_program():
    wl = W.matmul(256, 256, 256, "bfloat16")
    prog = _with_extra_candidate(space_lib.space_for(wl, V5E),
                                 "variant", "mxu_bogus")
    report = SA.analyze(wl, V5E, program=prog)
    assert report.exhaustive
    assert "mxu_bogus" in report.seen["variant"]
    assert "mxu_bogus" not in report.feasible["variant"]
    assert report.dead_values()["variant"] == ("mxu_bogus",)
    assert report.check_trace({"variant": "mxu_bogus"}) != ""
    assert report.check_trace({"variant": report.feasible["variant"][0]}) == ""


def test_empty_feasible_set_diagnostic():
    wl = W.matmul(256, 256, 256, "bfloat16")
    base = space_lib.space_for(wl, V5E)
    # every variant replaced by garbage: nothing can ever validate
    ins = [dataclasses.replace(
        i, candidates=(lambda ctx: ("bogus_a", "bogus_b")))
        if i.name == "variant" else i for i in base.instructions]
    prog = space_lib.SpaceProgram(wl, V5E, ins, base.postprocessors)
    report = SA.analyze(wl, V5E, program=prog)
    assert report.valid_traces == 0
    rules = {d.rule for d in report.diagnostics}
    assert SA.RULE_EMPTY in rules


def test_name_collision_diagnostic():
    wl = W.attention(1, 8, 8, 128, 128, 128)
    base = space_lib.space_for(wl, V5E)
    prog = space_lib.SpaceProgram(wl, V5E,
                                  list(base.instructions) * 2,
                                  base.postprocessors)
    report = SA.analyze(wl, V5E, program=prog)
    assert any(d.rule == SA.RULE_COLLISION for d in report.diagnostics)


def test_registered_spaces_lint_clean():
    """The shipped space definitions must be provably clean across the
    hardware sweep (the benchmarks/--suite static hard gate, in-tree)."""
    for wl in (W.matmul(512, 512, 512, "bfloat16"), W.gemv(512, 2048),
               W.vmacc(256, 1024)):
        diags = [d for d in SA.lint_space(wl) if d.rule != SA.RULE_DEAD]
        assert not diags, [str(d) for d in diags]


# ------------------------------------------------------- tuner integration ----

def test_fixed_seed_history_bit_identical_when_nothing_pruned():
    wl = W.matmul(512, 512, 512, "bfloat16")
    runner = AnalyticRunner(V5E)
    on = tune(wl, V5E, runner, trials=16, seed=7, static_analysis=True)
    off = tune(wl, V5E, runner, trials=16, seed=7, static_analysis=False)
    assert on.static_pruned == 0 and off.static_pruned == 0
    assert [(s.signature(), l) for s, l in on.history] == \
        [(s.signature(), l) for s, l in off.history]
    assert on.best_schedule == off.best_schedule
    assert on.best_latency == off.best_latency


def test_pruned_program_never_proposes_dead_candidates():
    wl = W.matmul(256, 256, 256, "bfloat16")
    prog = _with_extra_candidate(space_lib.space_for(wl, V5E),
                                 "variant", "mxu_bogus")
    report = SA.analyze(wl, V5E, program=prog)
    pruned_events = []
    filtered = SA.pruned_program(prog, report, pruned_events.append)
    assert filtered is not prog
    sampler = TraceSampler(0)
    for _ in range(64):
        s = sampler.sample(filtered)
        assert s["variant"] != "mxu_bogus"
    assert pruned_events and all(n == 1 for n in pruned_events)
    # the filter is load-bearing, not vacuous: without it, sampling either
    # proposes the dead value or crashes outright when it is drawn (the
    # downstream split generator can't compute a block for it)
    sampler = TraceSampler(0)
    hit = False
    for _ in range(64):
        try:
            s = sampler.sample(prog)
        except KeyError:
            hit = True
            break
        if s["variant"] == "mxu_bogus":
            hit = True
            break
    assert hit


def test_pruned_program_is_identity_when_nothing_to_prune():
    wl = W.matmul(256, 256, 256, "bfloat16")
    prog = space_lib.space_for(wl, V5E)
    report = SA.analyze(wl, V5E, program=prog)
    # same object: the rng-stream bit-identity contract by construction
    assert SA.pruned_program(prog, report) is prog


# ------------------------------------------------------ database quarantine ----

def _db_with_records(tmp_path, wl, hw_name, schedules_latencies):
    key = TuningDatabase.record_key(wl, hw_name)
    payload = {"records": {key: [
        {"schedule": sched, "latency_s": lat, "runner": "analytic"}
        for sched, lat in schedules_latencies]},
        "workloads": {key: wl.to_json()}, "sessions": []}
    path = str(tmp_path / "db.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def test_stale_record_quarantined_at_load_not_crashed_on(tmp_path):
    """A database holding a trace whose variant no longer exists in the
    space loads fine, quarantines the stale record with a reason, keeps the
    good one, and excludes the stale one from best() and warm-start."""
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    good = [{"name": "variant", "choice": "mxu_512", "candidates": []},
            {"name": "order", "choice": "mnk", "candidates": ["mnk", "nmk"]},
            {"name": "accumulate", "choice": True, "candidates": [True, False]}]
    stale = [{"name": "variant", "choice": "mxu_9999", "candidates": []},
             {"name": "order", "choice": "mnk", "candidates": ["mnk", "nmk"]}]
    db = TuningDatabase(_db_with_records(
        tmp_path, wl, V5E.name, [(stale, 0.5e-3), (good, 1e-3)]))
    key = TuningDatabase.record_key(wl, V5E.name)
    assert db.stale_quarantined == 1
    assert len(db.quarantined[key]) == 1
    assert "mxu_9999" in db.quarantined[key][0]["reason"]
    # the stale record had the better latency; it must still lose
    best = db.best(wl, V5E.name)
    assert best is not None and best[1] == 1e-3
    seeds = db.transfer_candidates(wl, V5E.name)
    assert seeds and all(s.get("variant") != "mxu_9999" for s in seeds)
    # quarantine survives a save/load round trip
    out = str(tmp_path / "resaved.json")
    db.save(out)
    db2 = TuningDatabase(out)
    assert len(db2.quarantined[key]) == 1


def test_malformed_record_quarantined(tmp_path):
    wl = W.matmul(512, 512, 512, "bfloat16")
    db = TuningDatabase(_db_with_records(
        tmp_path, wl, V5E.name, [({"not": "a schedule"}, 1e-3)]))
    assert db.stale_quarantined == 1
    assert db.best(wl, V5E.name) is None


def test_unknown_hardware_records_left_alone(tmp_path):
    """Records for a hardware name this build doesn't know can't be
    verified — they must load untouched, not be quarantined."""
    wl = W.matmul(512, 512, 512, "bfloat16")
    stale = [{"name": "variant", "choice": "mxu_9999", "candidates": []}]
    db = TuningDatabase(_db_with_records(
        tmp_path, wl, "tpu_v9_future", [(stale, 1e-3)]))
    assert db.stale_quarantined == 0
    assert len(db) == 1


def test_transfer_distributions_drop_statically_dead_values():
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    db = TuningDatabase()
    d = space_lib.DecisionDistribution()
    d.observe("mnk", 0.9)
    d.observe("nmk", 0.1)
    d.observe("zzz_gone", 1.0)  # stale: no longer a feasible order value
    db.set_distributions(wl, V5E.name, {"order": d.to_json()})
    priors = db.transfer_distributions(wl, V5E.name)
    assert "order" in priors
    assert "zzz_gone" not in priors["order"]
    assert "mnk" in priors["order"]


# --------------------------------------------------- farm/scheduler refusal ----

def _stale_schedule():
    return Schedule.fixed(variant="mxu_9999", order="mnk")


def test_board_farm_refuses_statically_invalid_work():
    wl = W.matmul(256, 256, 256, "bfloat16")
    prog = space_lib.space_for(wl, V5E)
    valid = TraceSampler(0).sample(prog)
    with simulated_farm(2, V5E) as farm:
        lats = farm.run_batch(wl, [valid, _stale_schedule()])
        assert math.isfinite(lats[0])
        assert lats[1] == INVALID
        assert farm.static_rejected == 1
        assert farm.farm_summary()["static_rejected"] == 1
        # a board never saw the refused candidate
        dispatched = sum(b.stats.dispatched for b in farm.boards)
        assert dispatched == 1


def test_board_farm_fully_refused_batch_completes_immediately():
    wl = W.matmul(256, 256, 256, "bfloat16")
    with simulated_farm(1, V5E) as farm:
        ticket = farm.submit_batch(wl, [_stale_schedule()] * 3)
        assert ticket.done()
        assert ticket.result() == [INVALID] * 3
        assert farm.static_rejected == 3
        assert sum(b.stats.dispatched for b in farm.boards) == 0


class _RecordingRunner(AnalyticRunner):
    """Analytic runner that records every schedule it is asked to run."""

    def __init__(self, hw):
        super().__init__(hw)
        self.seen = []

    def run(self, workload, schedule):
        self.seen.append(schedule)
        return super().run(workload, schedule)


def test_scheduler_screens_serial_backends():
    wl = W.matmul(256, 256, 256, "bfloat16")
    prog = space_lib.space_for(wl, V5E)
    valid = TraceSampler(0).sample(prog)
    runner = _RecordingRunner(V5E)
    with MeasureScheduler(runner) as sched:
        sched.submit(0, wl, [valid, _stale_schedule(), valid])
        _key, batch, lats, _w, _m = sched.collect_next()
        assert len(batch) == 3 and len(lats) == 3
        assert math.isfinite(lats[0]) and math.isfinite(lats[2])
        assert lats[1] == INVALID
        assert sched.static_rejected == 1
    # the backend runner only ever measured the two valid candidates
    assert len(runner.seen) == 2
    assert all(s.get("variant") != "mxu_9999" for s in runner.seen)


# ----------------------------------------------------------- vmem headroom ----

def test_vmem_headroom_is_one_authoritative_bound():
    import types
    assert V5E.vmem_budget == V5E.vmem_capacity * V5E.vmem_headroom
    tight = dataclasses.replace(V5E, vmem_headroom=1e-9)
    params = types.SimpleNamespace(vmem_bytes=1024)
    assert space_lib.postproc_vmem_fit(
        W.matmul(128, 128, 128), V5E, params) == ""
    msg = space_lib.postproc_vmem_fit(W.matmul(128, 128, 128), tight, params)
    assert "vmem" in msg


# ------------------------------------------------------- invariant linter ----

def _lint(src):
    sys.path.insert(0, "tools")
    try:
        from lint_invariants import lint_source
    finally:
        sys.path.pop(0)
    return lint_source(src, "x.py")


def test_lint_invariants_rules_fire():
    rows = _lint(
        "import numpy as np, random, time\n"
        "r = np.random.default_rng()\n"
        "random.shuffle([1])\n"
        "t = time.time()\n"
        "rng = np.random.default_rng(0)\n"
        "rng.choice(list({1: 2}.keys()))\n")
    rules = [r.split(": ")[1] for r in rows]
    assert rules == ["unseeded-rng", "unseeded-rng", "wall-clock",
                     "dict-order-rng"]


def test_lint_invariants_escape_hatch_and_blessed_clocks():
    rows = _lint(
        "import time, numpy as np\n"
        "a = time.perf_counter()\n"
        "b = time.monotonic()\n"
        "c = time.time()  # lint: allow(wall-clock)\n"
        "rng = np.random.default_rng(0)\n"
        "rng.choice(sorted({1: 2}))\n")
    assert rows == []


def test_core_is_lint_clean():
    import os
    sys.path.insert(0, "tools")
    try:
        from lint_invariants import lint_file
    finally:
        sys.path.pop(0)
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                        "core")
    findings = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            findings.extend(lint_file(os.path.join(root, name)))
    assert findings == [], findings
