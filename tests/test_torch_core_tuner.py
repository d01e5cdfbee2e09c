"""Tuning-loop tests: cost model, evolution, database, end-to-end tune().

The JAX package's ``tests/test_core_tuner.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

from repro_torch.core import (AnalyticRunner, RidgeCostModel, Schedule,
                              TraceSampler, TuningDatabase, V5E, V5E_VMEM32,
                              concretize, features, fixed_library_schedule,
                              space_for, tune)
from repro_torch.core import workload as W
from repro_torch.core.evolution import EvolutionarySearch


def test_cost_model_learns_ranking():
    """Fit on analytic latencies; the model must rank a clearly-bad schedule
    behind a clearly-good one."""
    wl = W.matmul(2048, 2048, 2048, "bfloat16")
    runner = AnalyticRunner(V5E)
    space = space_for(wl, V5E)
    sampler = TraceSampler(0)
    cm = RidgeCostModel()
    pairs = []
    while len(pairs) < 24:
        s = sampler.sample(space)
        p = concretize(wl, V5E, s)
        if not p.valid:
            continue
        lat = runner.run(wl, s)
        cm.update(features(wl, V5E, p), lat)
        pairs.append((s, lat))
    assert cm.fitted
    pairs.sort(key=lambda r: r[1])
    best, worst = pairs[0], pairs[-1]
    if worst[1] > best[1] * 1.5:  # only meaningful with real spread
        pb = cm.predict(features(wl, V5E, concretize(wl, V5E, best[0])))
        pw = cm.predict(features(wl, V5E, concretize(wl, V5E, worst[0])))
        assert pb < pw


def test_tune_beats_or_matches_fixed_library():
    """The paper's central claim at the unit level: tuned >= hand-written."""
    wl = W.matmul(512, 2048, 2048, "bfloat16")
    runner = AnalyticRunner(V5E)
    res = tune(wl, V5E, runner, trials=48, seed=0)
    fixed = runner.run(wl, fixed_library_schedule(wl, V5E))
    assert res.best_latency <= fixed
    assert res.trials == 48
    assert res.best_params.valid


def test_tune_deterministic():
    wl = W.matmul(256, 1024, 1024, "bfloat16")
    r1 = tune(wl, V5E, AnalyticRunner(V5E), trials=24, seed=5)
    r2 = tune(wl, V5E, AnalyticRunner(V5E), trials=24, seed=5)
    assert r1.best_schedule == r2.best_schedule
    assert r1.best_latency == r2.best_latency


def test_tune_adapts_to_hardware():
    """Fig. 4 property: re-tuning on a different hardware config must never
    be worse than shipping the other config's schedule."""
    wl = W.matmul(4096, 4096, 4096, "bfloat16")
    r_big = tune(wl, V5E, AnalyticRunner(V5E), trials=48, seed=0)
    r_small = tune(wl, V5E_VMEM32, AnalyticRunner(V5E_VMEM32), trials=48,
                   seed=0)
    carried = AnalyticRunner(V5E_VMEM32).run(wl, r_big.best_schedule)
    assert r_small.best_latency <= carried + 1e-12


def test_evolution_proposes_valid_unmeasured():
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    space = space_for(wl, V5E)
    sampler = TraceSampler(0)
    search = EvolutionarySearch(wl, V5E, space, sampler)
    search.seed_population([])
    assert len(search.population) > 0
    cm = RidgeCostModel()
    search.evolve(cm, elites=[])
    measured = {search.population[0].signature()}
    props = search.propose(4, exclude=measured)
    assert len(props) == 4
    for p in props:
        assert p.signature() not in measured
        assert concretize(wl, V5E, p).valid


def test_database_best_and_persistence(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    wl = W.matmul(64, 64, 64)
    s1 = Schedule.fixed(variant="a")
    s2 = Schedule.fixed(variant="b")
    db.add(wl, "hw", s1, 2e-3, "analytic")
    db.add(wl, "hw", s2, 1e-3, "analytic")
    # non-finite latencies are rejected at the database boundary (they carry
    # no information and are not representable in strict JSON)
    db.add(wl, "hw", s1, float("inf"), "analytic")
    db.add(wl, "hw", s1, float("nan"), "analytic")
    best = db.best(wl, "hw")
    assert best is not None
    assert best[0]["variant"] == "b" and best[1] == 1e-3
    db.save()
    db2 = TuningDatabase(str(tmp_path / "db.json"))
    assert db2.best(wl, "hw")[1] == 1e-3
    assert len(db2) == 2
    assert db2.best(W.matmul(1, 1, 1), "hw") is None


def test_tune_writes_database(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    wl = W.vmacc(256, 512)
    res = tune(wl, V5E, AnalyticRunner(V5E), trials=10, seed=0, database=db)
    rec = db.best(wl, V5E.name)
    assert rec is not None
    assert math.isclose(rec[1], res.best_latency)


def test_analytic_runner_monotonic_in_stores():
    """Store-heavy (accumulate=False) schedules must model slower — the
    Fig. 5 mechanism (muRISCV-NN's store traffic) in the latency model."""
    wl = W.matmul(2048, 2048, 8192, "bfloat16")
    runner = AnalyticRunner(V5E)
    space = space_for(wl, V5E)
    s = TraceSampler(0).sample(space)
    s_acc = s.replace("accumulate", True)
    s_no = s.replace("accumulate", False)
    assert runner.run(wl, s_acc) < runner.run(wl, s_no)
