"""Content-addressed build/measurement dedup suite.

Covers ``core/build_cache.py`` (LRU semantics under capacity pressure,
counter accuracy, cross-workload key isolation), the ``dedup`` knobs on
:class:`AnalyticRunner` and :class:`BoardFarm` (fan-out alignment, survival
of requeue-from-dead, hypothesis-tested inertness on the deterministic
analytic runner), the database's cross-session measured-latency memo plus
the tuner's ``reuse_measured`` consumption of it, and a ``--runslow``
case on the host (``EmulateRunner``, the reference's interpret path)
asserting a second identical batch performs zero kernel builds.

The JAX package's ``tests/test_build_cache.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import math

import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (AnalyticRunner, BuildCache, EmulateRunner,
                              Schedule, TraceSampler, TuningDatabase, V5E,
                              INTERPRET, build_cache_stats, clear_build_cache,
                              clear_concretize_cache, concretize,
                              concretize_cache_stats, fixed_library_schedule,
                              space_for, tune)
from repro_torch.core import workload as W
from repro_torch.core.build_cache import stats_delta

from _torch_sim_boards import RecordingMeasure, die_fault, make_farm


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
POP = _unique_samples(WL, V5E, 6)


# ------------------------------------------------------ BuildCache unit ----

def test_lru_eviction_under_capacity_pressure():
    cache = BuildCache(capacity=3)
    for i in range(5):
        cache.get_or_build(("k", i), lambda i=i: i)
    stats = cache.stats()
    assert len(cache) == 3
    assert stats["misses"] == 5 and stats["evictions"] == 2
    # oldest two fell off; the newest three survive
    assert cache.get(("k", 0)) is None and cache.get(("k", 1)) is None
    assert cache.get(("k", 4)) == 4
    # recency: a hit refreshes, so the *least recently used* is evicted next
    cache.get_or_build(("k", 2), lambda: -1)  # hit — must not rebuild
    cache.get_or_build(("k", 5), lambda: 5)
    assert ("k", 2) in cache and ("k", 3) not in cache


def test_capacity_must_be_positive():
    with pytest.raises(ValueError):
        BuildCache(capacity=0)


def test_counter_accuracy():
    cache = BuildCache(capacity=8)
    builds = []
    for _ in range(4):
        cache.get_or_build("a", lambda: builds.append(1) or "v")
    assert len(builds) == 1  # built exactly once
    stats = cache.stats()
    assert stats == {"hits": 3, "misses": 1, "evictions": 0,
                     "size": 1, "capacity": 8}
    # probes are uncounted — only get_or_build moves the counters
    assert cache.get("a") == "v" and "a" in cache
    assert cache.get("missing") is None
    assert cache.stats() == stats
    cache.clear()
    assert len(cache) == 0
    assert cache.stats()["hits"] == 0 and cache.stats()["misses"] == 0


def test_builder_exception_caches_nothing():
    cache = BuildCache(capacity=4)

    def boom():
        raise RuntimeError("lowering crashed")

    with pytest.raises(RuntimeError):
        cache.get_or_build("k", boom)
    stats = cache.stats()
    assert len(cache) == 0 and stats["hits"] == 0 and stats["misses"] == 0
    # a crashed build is retried, not poisoned
    assert cache.get_or_build("k", lambda: 7) == 7


def test_stats_delta_is_counter_delta_level_snapshot():
    before = {"hits": 2, "misses": 5, "evictions": 1,
              "size": 4, "capacity": 128}
    after = {"hits": 10, "misses": 6, "evictions": 1,
             "size": 5, "capacity": 128}
    assert stats_delta(after, before) == {
        "hits": 8, "misses": 1, "evictions": 0, "size": 5, "capacity": 128}


# -------------------------------------------------------- key isolation ----

def test_cross_workload_key_isolation():
    """Two workloads whose params differ must never share a cache entry,
    while re-concretizing the *same* workload through a distinct but equal
    schedule object must land on the same key (content addressing)."""
    wl_a = W.matmul(256, 256, 256, "float32")
    wl_b = W.matmul(256, 256, 512, "float32")
    pa = concretize(wl_a, V5E, fixed_library_schedule(wl_a, V5E))
    pb = concretize(wl_b, V5E, fixed_library_schedule(wl_b, V5E))
    assert pa.valid and pb.valid
    assert pa.signature() != pb.signature()

    cache = BuildCache(capacity=8)
    assert cache.get_or_build((pa.signature(), True), lambda: "a") == "a"
    assert cache.get_or_build((pb.signature(), True), lambda: "b") == "b"
    # isolated: a's entry is untouched by b's, and vice versa
    assert cache.get_or_build((pa.signature(), True), lambda: "X") == "a"
    # the device flag is part of the key (the reference's interpret flag):
    # builds of the same params for two devices are distinct artifacts
    assert cache.get_or_build((pa.signature(), False), lambda: "c") == "c"
    assert len(cache) == 3

    # same lowering reached through a JSON round-tripped schedule object:
    # identical content key, so the build is shared
    rt = Schedule.from_json(fixed_library_schedule(wl_a, V5E).to_json())
    assert concretize(wl_a, V5E, rt).signature() == pa.signature()


def test_concretize_memo_hits_and_identity():
    clear_concretize_cache()
    wl = W.matmul(256, 256, 256, "float32")
    sched = fixed_library_schedule(wl, V5E)
    p1 = concretize(wl, V5E, sched)
    p2 = concretize(wl, V5E, sched)
    assert p2 is p1  # memoized, not re-derived
    stats = concretize_cache_stats()
    assert stats["misses"] == 1 and stats["hits"] >= 1


# ------------------------------------------------- runner / farm dedup ----

def test_analytic_dedup_fanout_alignment():
    a, b, c = POP[:3]
    schedules = [a, b, a, c, b, a]
    on = AnalyticRunner(V5E, dedup=True).run_batch(WL, schedules)
    off = AnalyticRunner(V5E).run_batch(WL, schedules)
    assert on == off
    assert on[0] == on[2] == on[5] and on[1] == on[4]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=16))
def test_analytic_dedup_inert_property(picks):
    """Acceptance: dedup-on is bit-identical to dedup-off on the
    deterministic analytic runner, for any duplication pattern."""
    schedules = [POP[i] for i in picks]
    on = AnalyticRunner(V5E, dedup=True).run_batch(WL, schedules)
    off = AnalyticRunner(V5E).run_batch(WL, schedules)
    assert on == off


def test_farm_dedup_fanout_survives_requeue_from_dead():
    """A dedup'd batch on a farm where the board holding a representative
    dies: the item requeues to a live board, and every follower position
    still settles with the representative's latency — results stay
    bit-identical to a plain single-board run of the full batch."""
    a, b, c = POP[:3]
    schedules = [a, b, a, c, b]
    reference = AnalyticRunner(V5E).run_batch(WL, schedules)

    meas = RecordingMeasure()
    farm = make_farm(2, delay_s=[0.0, 0.002], faults={0: [die_fault(0)]},
                     measure_fn=meas, dedup=True)
    got = farm.run_batch(WL, schedules)
    assert got == reference
    assert got[0] == got[2] and got[1] == got[4]
    # exactly-once: three distinct signatures, three measurements total,
    # even though five candidates were submitted and one board died
    assert sum(meas.calls.values()) == 3
    assert set(meas.calls.values()) == {1}
    summary = farm.farm_summary()
    assert summary["dedup_reused"] == 2
    assert summary["requeues"] >= 1
    assert "build_cache" in summary


def test_farm_dedup_off_by_default_measures_every_position():
    a, b, c = POP[:3]
    schedules = [a, b, a, c, b]
    meas = RecordingMeasure()
    farm = make_farm(2, measure_fn=meas)
    got = farm.run_batch(WL, schedules)
    assert got == AnalyticRunner(V5E).run_batch(WL, schedules)
    assert sum(meas.calls.values()) == 5  # no dedup: one measure per slot
    assert farm.farm_summary()["dedup_reused"] == 0


# ------------------------------------- cross-session measured-lat memo ----

def test_measured_latency_memo_equal_fidelity_and_invalidation():
    db = TuningDatabase()
    sched, other = POP[0], POP[1]
    assert db.measured_latency(WL, V5E.name, sched) is None

    db.add(WL, V5E.name, sched, 1.5e-3, "analytic")
    db.add(WL, V5E.name, sched, 1.2e-3, "analytic")  # better re-run
    db.add(WL, V5E.name, sched, 9.0e-4, "interpret")

    # equal fidelity: a runner only reuses its own kind of measurement
    got = db.measured_latency(WL, V5E.name, sched, runner_name="analytic")
    assert got == pytest.approx(1.2e-3)  # best of the matching records
    got = db.measured_latency(WL, V5E.name, sched, runner_name="interpret")
    assert got == pytest.approx(9.0e-4)
    # fidelity-agnostic lookup takes the global best
    assert db.measured_latency(WL, V5E.name, sched) == pytest.approx(9.0e-4)
    # no record at that fidelity / for that schedule / on that hardware
    assert db.measured_latency(WL, V5E.name, sched, runner_name="farm") is None
    assert db.measured_latency(WL, V5E.name, other, runner_name="analytic") is None
    assert db.measured_latency(WL, "other-hw", sched) is None
    assert db.measured_memo == 3  # only hits count

    # add() invalidates the index: the new record is immediately visible
    db.add(WL, V5E.name, other, 2.0e-3, "analytic")
    got = db.measured_latency(WL, V5E.name, other, runner_name="analytic")
    assert got == pytest.approx(2.0e-3)
    assert db.measured_memo == 4


def test_reuse_measured_replays_history_bit_identical():
    """A re-tune over a warm database with ``reuse_measured=True`` settles
    candidates from the memo instead of the runner — and, on the
    deterministic analytic runner, produces the bit-identical history the
    knob-off run produces (acceptance: memoization never changes what a
    fixed seed sees)."""
    wl = W.gemv(512, 512, "float32")
    db = TuningDatabase()
    runner = AnalyticRunner(V5E)

    base = tune(wl, V5E, runner, trials=24, seed=3, database=db)
    off = tune(wl, V5E, runner, trials=24, seed=3, database=db)
    on = tune(wl, V5E, runner, trials=24, seed=3, database=db,
              reuse_measured=True)

    def hist(result):
        return [(s.signature(), lat) for s, lat in result.history]

    assert hist(base) == hist(off) == hist(on)
    assert on.best_latency == base.best_latency
    assert base.measured_memo == 0  # knob off: memo never consulted
    assert on.measured_memo > 0     # knob on over a warm db: hits happened
    # build-cache counters surface on every result (zero deltas on the
    # build-free analytic runner, but the shape is always there)
    assert set(base.build_cache) >= {"hits", "misses", "evictions"}


# ----------------------------------------------------- host build path ----

@pytest.mark.slow
def test_interpret_second_identical_batch_performs_zero_builds():
    wl = W.matmul(128, 128, 128, "float32")
    schedules = _unique_samples(wl, INTERPRET, 2)
    runner = EmulateRunner(INTERPRET, repeats=1, warmup=0)

    clear_build_cache()
    before = build_cache_stats()
    cold = runner.run_batch(wl, schedules)
    assert all(math.isfinite(x) for x in cold)
    mid = build_cache_stats()
    assert mid["misses"] - before["misses"] == len(schedules)

    warm = runner.run_batch(wl, schedules)
    after = build_cache_stats()
    assert after["misses"] == mid["misses"]  # zero builds on the warm pass
    assert after["hits"] - mid["hits"] >= len(schedules)
    assert warm == cold or all(math.isfinite(x) for x in warm)
