"""The port's traffic-driven continuous tuning: every case of the JAX
package's test_traffic_tuning.py with its assertions (TrafficLog dedup and
bounds, dispatch miss recording, dynamic-shape bucketing, ContinuousTuner
prioritization and background operation, global-database hot swap, the
bit-identity guarantee when the traffic layer is off, the dispatch-aware
Server on the port's models) on ``AnalyticRunner(V5E)``, plus one
continuous-tuning case on ``EmulateRunner(H100)``: the kernels' plain
versions measured on the host; and the JAX package's ``ContinuousTuner``
on the same recorded traffic, cycle by cycle, with identical records."""

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

from repro_torch.core import (H100, AnalyticRunner,  # noqa: E402
                              ContinuousTuner, EmulateRunner, Schedule,
                              TrafficLog, TuningDatabase, V5E, best_schedule,
                              fixed_library_schedule, installed_log,
                              kernel_params, set_traffic_log, tune)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.database import (global_database,  # noqa: E402
                                       reset_global_database)


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """Isolated dispatch environment: a throwaway global-database path and
    no process-wide traffic log, restored afterwards."""
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "db.json"))
    reset_global_database()
    prev = set_traffic_log(None)
    yield tmp_path / "db.json"
    set_traffic_log(prev)
    reset_global_database()


# ------------------------------------------------------------ TrafficLog ----

def test_record_dedups_and_counts_hits():
    log = TrafficLog()
    wl = W.matmul(8, 64, 64)
    for _ in range(5):
        log.record(wl, V5E.name, "fixed")
    log.record(wl, V5E.name, "bucketed", count=2)
    assert len(log) == 1  # one entry per distinct (workload, hw)
    (entry,) = log.hottest()
    assert entry.hits == 7
    assert entry.by_provenance == {"fixed": 5, "bucketed": 2}
    assert log.recorded == 7


def test_capacity_bound_evicts_coldest_first():
    log = TrafficLog(capacity=3)
    hot, warm, cold = (W.matmul(m, 64, 64) for m in (8, 16, 32))
    log.record(hot, V5E.name, count=5)
    log.record(warm, V5E.name, count=3)
    log.record(cold, V5E.name, count=1)
    log.record(W.matmul(64, 64, 64), V5E.name)  # full: must evict `cold`
    assert len(log) == 3
    assert log.evictions == 1
    keys = {e.workload.key() for e in log.hottest()}
    assert cold.key() not in keys and hot.key() in keys


def test_hottest_orders_by_hits_then_first_seen():
    log = TrafficLog()
    a, b, c = (W.matmul(m, 64, 64) for m in (8, 16, 32))
    log.record(a, V5E.name, count=2)
    log.record(b, V5E.name, count=7)
    log.record(c, V5E.name, count=2)  # ties with a; a was seen first
    assert [e.workload.key() for e in log.hottest()] == \
        [b.key(), a.key(), c.key()]


def test_drain_removes_and_filters_by_hw():
    log = TrafficLog()
    wl = W.matmul(8, 64, 64)
    log.record(wl, V5E.name, count=3)
    log.record(wl, "other_hw", count=9)
    taken = log.drain(hw_name=V5E.name)
    assert [e.hw_name for e in taken] == [V5E.name]
    assert taken[0].hits == 3
    assert log.pending(V5E.name) == 0
    assert log.pending("other_hw") == 1  # foreign-hw entries stay logged


# ------------------------------------------------- dispatch miss recording ----

def test_best_schedule_records_miss_with_explicit_log(fresh):
    log = TrafficLog()
    wl = W.matmul(8, 64, 64)
    _, prov = best_schedule(wl, V5E, database=TuningDatabase(), traffic=log)
    assert prov == "fixed"
    (entry,) = log.hottest()
    assert entry.workload.key() == wl.key()
    assert entry.by_provenance == {"fixed": 1}
    # xla misses (fixed library disallowed) are recorded too
    _, prov = best_schedule(wl, V5E, database=TuningDatabase(),
                            allow_fixed=False, traffic=log)
    assert prov == "xla"
    assert log.hottest()[0].by_provenance == {"fixed": 1, "xla": 1}


def test_tuned_hit_is_not_recorded(fresh):
    db = TuningDatabase()
    log = TrafficLog()
    wl = W.matmul(8, 64, 64)
    db.add(wl, V5E.name, fixed_library_schedule(wl, V5E), 1e-3, "analytic")
    _, prov = best_schedule(wl, V5E, database=db, traffic=log)
    assert prov == "tuned"
    assert len(log) == 0  # hits are not misses


def test_installed_log_default_off_then_records(fresh):
    wl = W.matmul(8, 64, 64)
    assert installed_log() is None  # default: traffic layer fully off
    _, prov = best_schedule(wl, V5E, database=TuningDatabase())
    assert prov == "fixed"  # no log, no recording, no error
    log = TrafficLog()
    assert set_traffic_log(log) is None
    best_schedule(wl, V5E, database=TuningDatabase())
    assert set_traffic_log(None) is log  # returns previous for restore
    assert log.hottest()[0].workload.key() == wl.key()


# ------------------------------------------------- dynamic-shape bucketing ----

def _db_with_tuned(wl, latency=1e-3):
    """A database holding one 'tuned' record: the fixed-library schedule of
    ``wl`` (v1 relative-scale trace, so it concretizes on neighbours)."""
    db = TuningDatabase()
    db.add(wl, V5E.name, fixed_library_schedule(wl, V5E), latency, "analytic")
    return db


def test_unseen_shape_dispatches_to_nearest_bucket(fresh):
    tuned_wl = W.matmul(8, 256, 64)
    near_wl = W.matmul(8, 256, 128)  # unseen: same op/rank, k doubled
    db = _db_with_tuned(tuned_wl)
    log = TrafficLog()
    sched, prov = best_schedule(near_wl, V5E, database=db, traffic=log)
    assert prov == "bucketed"
    assert sched.signature() == \
        fixed_library_schedule(tuned_wl, V5E).signature()
    # a near miss is still a miss: recorded so the tuner closes the gap
    assert log.hottest()[0].by_provenance == {"bucketed": 1}
    # opt-out restores the old two-rung behaviour
    _, prov = best_schedule(near_wl, V5E, database=db, allow_bucketed=False)
    assert prov == "fixed"


def test_bucket_prefers_closest_shape(fresh):
    def sched(m_scale):
        return Schedule.fixed(variant="mxu_min", m_scale=m_scale,
                              n_scale=1.0, k_scale=1.0, order="mnk",
                              accumulate=True)

    near, far = W.matmul(8, 256, 128), W.matmul(8, 256, 1024)
    db = TuningDatabase()
    db.add(near, V5E.name, sched(1.0), 2e-3, "analytic")
    db.add(far, V5E.name, sched(0.25), 1e-3, "analytic")
    result = db.nearest_tuned(W.matmul(8, 256, 256), V5E)
    assert result is not None
    got, _, source_key = result
    assert got["m_scale"] == 1.0  # distance beats latency
    assert source_key == db.record_key(near, V5E.name)


def test_bucket_requires_same_op_same_hw(fresh):
    query = W.matmul(8, 256, 128)
    other_op = _db_with_tuned(W.qmatmul(8, 256, 64))
    assert other_op.nearest_tuned(query, V5E) is None
    other_hw = TuningDatabase()
    other_hw.add(W.matmul(8, 256, 64), "foreign_hw",
                 fixed_library_schedule(W.matmul(8, 256, 64), V5E),
                 1e-3, "analytic")
    assert other_hw.nearest_tuned(query, V5E) is None
    _, prov = best_schedule(query, V5E, database=other_op)
    assert prov == "fixed"


def test_bucket_skips_cross_rank_records(fresh):
    db = _db_with_tuned(W.matmul(8, 256, 64))
    assert db.nearest_tuned(W.gemv(256, 64), V5E) is None  # rank 2 vs 3


def test_bucket_falls_back_when_schedule_does_not_concretize(fresh,
                                                             monkeypatch):
    from repro_torch.core import database as db_lib

    tuned_wl = W.matmul(8, 256, 64)
    db = _db_with_tuned(tuned_wl)
    query = W.matmul(8, 256, 128)

    class Invalid:
        valid = False

    monkeypatch.setattr(db_lib.space_lib, "concretize",
                        lambda *a, **k: Invalid())
    assert db.nearest_tuned(query, V5E) is None
    sched, prov = best_schedule(query, V5E, database=db)
    assert prov == "fixed" and sched is not None
    monkeypatch.undo()
    db._bucket_cache.clear()  # drop the memoized None
    _, prov = best_schedule(query, V5E, database=db)
    assert prov == "bucketed"


def test_bucket_cache_invalidated_by_exact_add(fresh):
    tuned_wl = W.matmul(8, 256, 64)
    query = W.matmul(8, 256, 128)
    db = _db_with_tuned(tuned_wl)
    _, prov = best_schedule(query, V5E, database=db)
    assert prov == "bucketed"
    db.add(query, V5E.name, fixed_library_schedule(query, V5E), 5e-4,
           "analytic")
    _, prov = best_schedule(query, V5E, database=db)
    assert prov == "tuned"  # exact record beats the memoized bucket


# -------------------------------------------------------- ContinuousTuner ----

def test_tune_once_empty_log_is_a_noop(fresh):
    tuner = ContinuousTuner(TrafficLog(), V5E, runner=AnalyticRunner(V5E))
    assert tuner.tune_once() is None
    assert tuner.cycles == 0


def test_tune_once_prioritizes_hottest_shape(fresh):
    log = TrafficLog()
    hot, cold = W.matmul(8, 64, 64), W.matmul(16, 64, 64)
    log.record(hot, V5E.name, count=5)
    log.record(cold, V5E.name, count=1)
    tuner = ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E),
                            trials_per_shape=6, max_shapes_per_cycle=1)
    result = tuner.tune_once()
    assert result is not None and tuner.cycles == 1
    assert tuner.database.best(hot, V5E.name) is not None  # hottest tuned
    assert tuner.database.best(cold, V5E.name) is None  # still pending
    assert log.pending(V5E.name) == 1
    tuner.tune_once()
    assert tuner.database.best(cold, V5E.name) is not None
    assert log.pending(V5E.name) == 0


def test_miss_tune_redispatch_roundtrip(fresh):
    """The in-process loop: a miss is recorded, one cycle tunes it against
    the shared database, and the same dispatch call flips to tuned."""
    db = TuningDatabase()
    log = TrafficLog()
    wl = W.gemv(256, 64)
    _, prov = best_schedule(wl, V5E, database=db, traffic=log)
    assert prov == "fixed"
    ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E), database=db,
                    trials_per_shape=6).tune_once()
    _, prov = best_schedule(wl, V5E, database=db, traffic=log)
    assert prov == "tuned"
    assert len(log) == 0  # drained, and the hit recorded no new miss


def test_background_thread_tunes_and_stops(fresh):
    log = TrafficLog()
    wl = W.matmul(8, 64, 64)
    log.record(wl, V5E.name, count=3)
    tuner = ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E),
                            trials_per_shape=6, poll_interval_s=0.01)
    with tuner:
        assert tuner.wait_idle(timeout=30.0)
        assert tuner.database.best(wl, V5E.name) is not None
    assert tuner._thread is None
    assert tuner.cycles >= 1 and tuner.error is None


def test_background_failure_surfaces_in_wait_idle(fresh):
    log = TrafficLog()
    log.record(W.matmul(8, 64, 64), V5E.name)

    class Boom:
        def measure(self, *a, **k):
            raise RuntimeError("board on fire")

    tuner = ContinuousTuner(log, V5E, runner=Boom(), poll_interval_s=0.01)
    with tuner:
        with pytest.raises(RuntimeError):
            tuner.wait_idle(timeout=30.0)


def test_end_to_end_hot_swap_through_global_database(fresh):
    """The acceptance loop at unit scale: a cold global database, a miss
    recorded at dispatch, a tuner cycle saving the artifact, and the very
    next dispatch — same process, no reset — resolving tuned."""
    db_path = fresh
    log = TrafficLog()
    wl = W.matmul(8, 128, 64)
    _, prov = best_schedule(wl, V5E, traffic=log)  # global db: empty
    assert prov == "fixed"
    before = global_database()
    tuner = ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E),
                            db_path=str(db_path), trials_per_shape=6)
    assert tuner.tune_once() is not None
    _, prov = best_schedule(wl, V5E)
    assert prov == "tuned"  # hot-swapped: no reset_global_database()
    assert global_database() is before  # reloaded in place, same instance


def test_traffic_layer_off_keeps_histories_bit_identical(fresh):
    """Recording traffic must not perturb the search: fixed-seed tuning
    histories are bit-identical with and without an installed log."""
    wl = W.matmul(16, 128, 128)

    def history():
        res = tune(wl, V5E, AnalyticRunner(V5E), trials=12, seed=3,
                   database=TuningDatabase())
        return [(s.signature(), lat) for s, lat in res.history]

    baseline = history()
    set_traffic_log(TrafficLog())
    try:
        with_log = history()
    finally:
        set_traffic_log(None)
    assert with_log == baseline and len(baseline) > 0


# ----------------------------------------------------- dispatch-aware Server --

def test_server_dispatch_counts_and_continuous_tuning(fresh):
    """A dispatch-aware Server reports the provenance mix per generate and
    flips to tuned after a ContinuousTuner cycle on its recorded misses."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.serve_loop import Server, decode_ops

    cfg = get_config("yi_6b").reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(2))
    ops = decode_ops(cfg, batch=2)
    db = TuningDatabase()
    log = TrafficLog()
    server = Server(bundle, params, max_len=32, hw=V5E, serve_ops=ops,
                    traffic=log, database=db)
    prompts = np.asarray(
        bundle.make_batch(0, ShapeSpec("p", 8, 2, "decode"),
                          train=False)["tokens"])
    cold = server.generate(prompts, n_steps=2)
    total = sum(count for count, _ in ops)
    assert cold.dispatch == {"fixed": total}  # cold DB: all fixed
    assert log.pending(V5E.name) == len({wl.key() for _, wl in ops})
    ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E), database=db,
                    trials_per_shape=4,
                    max_shapes_per_cycle=len(ops)).tune_once()
    warm = server.generate(prompts, n_steps=2)
    assert warm.dispatch.get("tuned", 0) >= 1
    assert warm.dispatch.get("fixed", 0) < total
    # a dispatch-less server keeps the old contract
    plain = Server(bundle, params, max_len=32)
    assert plain.generate(prompts, n_steps=2).dispatch is None


def test_decode_ops_shapes():
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve_loop import decode_ops

    cfg = get_config("yi_6b").reduced()
    single = decode_ops(cfg, batch=1)
    assert all(wl.op == "gemv" for _, wl in single)  # edge decode: gemv
    batched = decode_ops(cfg, batch=4)
    assert all(wl.op == "matmul" and wl.dims[0] == 4 for _, wl in batched)
    assert all(count >= 1 for count, _ in batched)
    qkv = batched[0][1]
    assert qkv.dims == (4, cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model)


# ----------------------------------------- the port: measured on the host ----

def test_continuous_tuning_on_emulate_runner_h100(fresh):
    """The loop on the H100's design space with real measurement: misses at
    dispatch (an op counted twice per step), one ``tune_once`` cycle timing
    the kernels' plain versions on the host, and the same dispatch then
    resolving "tuned" to a schedule that concretizes valid on the H100."""
    db = TuningDatabase()
    log = TrafficLog()
    ops = [(2, W.gemv(64, 32, "bfloat16")), (1, W.matmul(4, 32, 32))]
    for count, wl in ops:
        _, prov = best_schedule(wl, H100, database=db, traffic=log,
                                count=count)
        assert prov == "fixed"
    assert [e.hits for e in log.hottest(hw_name=H100.name)] == [2, 1]
    tuner = ContinuousTuner(log, H100, runner=EmulateRunner(H100),
                            database=db, trials_per_shape=3,
                            max_shapes_per_cycle=len(ops))
    result = tuner.tune_once()
    assert result is not None and tuner.shapes_tuned == 2
    assert log.pending(H100.name) == 0
    for _, wl in ops:
        params, prov = kernel_params(wl, H100, database=db, traffic=log)
        assert prov == "tuned" and params.valid
        assert 0 < db.best(wl, H100.name)[1] < float("inf")
    assert len(log) == 0  # tuned hits record nothing


# ------------------------------------------------ against the JAX package ----

def test_continuous_tuning_matches_reference_on_recorded_traffic(fresh):
    """The same decode traffic (MobileLLM-125M's, at batch 1 and 4) recorded at
    dispatch into each package's ``TrafficLog`` and tuned in cycles of three
    shapes on ``AnalyticRunner(V5E)``: the logs hold the same entries, and
    after every cycle the drained shapes, the database records (schedules
    and latencies), ``cycles`` and ``shapes_tuned`` are identical."""
    import json

    import jax  # noqa: F401  (the reference package runs on JAX)
    from repro import core as ref
    from repro.configs import get_config as ref_get_config
    from repro.runtime.serve_loop import decode_ops as ref_decode_ops

    from repro_torch import core as port
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve_loop import decode_ops

    def record(pkg, hw, cfg, ops_of):
        db, log = pkg.TuningDatabase(), pkg.TrafficLog()
        for batch in (1, 4):
            for count, wl in ops_of(cfg, batch):
                _, prov = pkg.best_schedule(wl, hw, database=db, traffic=log,
                                            count=count)
                assert prov == "fixed"
        return db, log

    def entries(log, hw):
        return [(e.workload.key(), e.hits, e.by_provenance)
                for e in log.hottest(hw_name=hw.name)]

    db, log = record(port, V5E, get_config("mobilellm_125m"), decode_ops)
    ref_db, ref_log = record(ref, ref.V5E, ref_get_config("mobilellm_125m"),
                             ref_decode_ops)
    assert entries(log, V5E) == entries(ref_log, ref.V5E)
    n_shapes = len(log)
    assert n_shapes > 3  # more than one cycle's worth
    ours = ContinuousTuner(log, V5E, runner=AnalyticRunner(V5E), database=db,
                           trials_per_shape=6, max_shapes_per_cycle=3, seed=7)
    theirs = ref.ContinuousTuner(ref_log, ref.V5E,
                                 runner=ref.AnalyticRunner(ref.V5E),
                                 database=ref_db, trials_per_shape=6,
                                 max_shapes_per_cycle=3, seed=7)
    while True:
        a, b = ours.tune_once(), theirs.tune_once()
        assert (a is None) == (b is None)
        if a is None:
            break
        assert [(r.count, r.workload.key(), r.best_latency, r.fixed_latency)
                for r in a.reports] == \
            [(r.count, r.workload.key(), r.best_latency, r.fixed_latency)
             for r in b.reports]
        assert json.dumps(db.records) == json.dumps(ref_db.records)
        assert (ours.cycles, ours.shapes_tuned) == \
            (theirs.cycles, theirs.shapes_tuned)
        assert entries(log, V5E) == entries(ref_log, ref.V5E)
    assert ours.shapes_tuned == n_shapes and ours.cycles == -(-n_shapes // 3)
    assert json.dumps(db.distributions) == json.dumps(ref_db.distributions)
