"""Generative design-space program tests: trace replay coherence
(mutation/crossover), v1→v2 schedule compatibility, v1 database
dispatch/warm-start, sufficient-statistics cost model, and space size.

The JAX package's ``tests/test_space_program.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (AnalyticRunner, RidgeCostModel, Schedule,
                              TraceSampler, TuningDatabase, V5E, INTERPRET,
                              best_schedule, concretize, features, flat_space_v1,
                              space_for, tune, v1_distinct_configs)
from repro_torch.core import space as space_lib
from repro_torch.core import workload as W
from repro_torch.core.space import (SpaceProgram, postproc_block_alignment,
                                    postproc_nonempty_grid, tile_candidates)


# ---------------------------------------------------- dependent candidates ----

def test_tile_candidates_depend_on_variant():
    """The acceptance property: pick a different intrinsic variant and the
    tile-split candidate sets change (they derive from the variant's base
    block), which the flat v1 space could never express."""
    wl = W.matmul(2048, 2048, 2048, "bfloat16")
    prog = space_for(wl, V5E)
    variants = prog["variant"]
    assert len(variants) >= 2
    big = prog.candidates("bm", {"variant": variants[0]})
    small = prog.candidates("bm", {"variant": variants[-1]})
    assert big != small
    assert set(small) < set(big)


def test_sampled_trace_records_variant_conditioned_candidates():
    wl = W.matmul(2048, 2048, 2048, "bfloat16")
    prog = space_for(wl, V5E)
    smp = TraceSampler(0)
    # force both extremes of the ladder through replay pinning
    lo = prog.replay({"variant": prog["variant"][-1]}, smp.rng)
    hi = prog.replay({"variant": prog["variant"][0]}, smp.rng)
    d_lo = next(d for d in lo.decisions if d.name == "bm")
    d_hi = next(d for d in hi.decisions if d.name == "bm")
    assert d_lo.candidates != d_hi.candidates


def test_accumulate_conditions_on_k_split():
    """A single-k-step schedule has no partials to revisit: the program only
    offers accumulate=True there."""
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_for(wl, V5E)
    variants = prog["variant"]
    full_k = prog.candidates("accumulate", {"variant": variants[0],
                                            "bk": 512})
    split_k = prog.candidates("accumulate", {"variant": variants[0],
                                             "bk": 128})
    assert full_k == (True,)
    assert set(split_k) == {True, False}


def test_tile_candidates_are_perfect_and_embed_v1_anchors():
    cands = tile_candidates(12288, 128, 2048)
    assert cands
    for c in cands:
        assert c % 128 == 0
    # real factorizations of the padded extent appear (3 * 4096 = 12288)
    assert 384 in cands or 768 in cands
    # the v1 SCALES anchors of the base block are embedded
    for anchor in (2048, 1024, 512):
        assert anchor in cands


def test_program_space_strictly_larger_than_v1():
    for wl in (W.matmul(2048, 2048, 2048, "bfloat16"),
               W.qmatmul(2048, 2048, 2048),
               W.gemv(4096, 12288, "bfloat16")):
        prog = space_for(wl, V5E)
        assert prog.distinct_configs() > v1_distinct_configs(wl, V5E), wl.op


# ------------------------------------------------------- gemv bn split ----

def test_gemv_bn_split_is_kernel_gated_and_variant_conditioned():
    """The bn (output-row / J) axis is a real split: several candidates for
    wide n, every one accepted by the kernel's own block-shape capability
    check, and the J=1 fallback variant keeps its single-row form."""
    from repro_torch.kernels.gemv.ops import supports_block_shape

    wl = W.gemv(4096, 12288, "bfloat16")
    prog = space_for(wl, V5E)
    assert "bn" in prog.names()
    lane = V5E.lane_align(wl.dtype)
    vl_variant = next(v for v in prog["variant"] if v != "j1")
    ctx = {"variant": vl_variant}
    ctx["bk"] = prog.candidates("bk", ctx)[0]
    cands = prog.candidates("bn", ctx)
    assert len(cands) >= 2  # genuinely widened vs the variant-derived value
    for c in cands:
        assert supports_block_shape(c, ctx["bk"], lane)
        assert c == 1 or c % lane == 0
    j1 = {"variant": "j1"}
    j1["bk"] = prog.candidates("bk", j1)[0]
    assert prog.candidates("bn", j1) == (1,)


def test_gemv_bn_split_concretizes_perfect_tiles():
    """Pinned bn values flow through concretize: the padded n extent is a
    perfect multiple of the chosen block, and the alignment postprocessor
    accepts exactly the kernel-supported shapes."""
    wl = W.gemv(4096, 12288, "bfloat16")
    prog = space_for(wl, V5E)
    smp = TraceSampler(0)
    seen_bn = set()
    for _ in range(64):
        s = smp.sample(prog)
        p = concretize(wl, V5E, s)
        seen_bn.add(p.block[0])
        assert p.block[0] == s["bn"]
        assert p.padded_dims[0] % p.block[0] == 0
        assert p.padded_dims[1] % p.block[1] == 0
    assert len(seen_bn) >= 2  # sampling actually explores the new axis


def test_gemv_v1_trace_still_concretizes_variant_derived_bn():
    """v1 flat traces (library schedules, old records) have no bn decision:
    the legacy path must keep producing the variant-derived bn, and adopt
    must translate them onto the program with identical concrete params."""
    from repro_torch.core import fixed_library_schedule

    # n = 1 is the sharp edge: the v1 path clamps bn to min(base, n) = 1,
    # so adoption must not snap it up to a full-lane block
    for wl in (W.gemv(1024, 4096), W.gemv(96, 256, "bfloat16"),
               W.gemv(1, 256), W.gemv(1, 4096, "bfloat16")):
        prog = space_for(wl, V5E)
        fx = fixed_library_schedule(wl, V5E)
        adopted = prog.adopt(fx, TraceSampler(0).rng)
        assert adopted.get("bn") is not None  # the program trace carries it
        assert concretize(wl, V5E, adopted) == concretize(wl, V5E, fx)


# ------------------------------------------------------------ trace replay ----

def _structurally_coherent(prog, trace):
    """Every decision is in its (upstream-conditioned) candidate set and the
    concrete params pass the structural postprocessors; only VMEM fit may
    legitimately reject a coherent trace."""
    ctx = {}
    for d in trace.decisions:
        cands = prog.candidates(d.name, ctx)
        assert d.choice in cands, (d.name, d.choice, cands)
        assert d.candidates == cands
        ctx[d.name] = d.choice
    p = concretize(prog.workload, prog.hw, trace,
                   postprocessors=(postproc_block_alignment,
                                   postproc_nonempty_grid))
    assert p.valid, p.why_invalid
    return p


def test_replay_fully_pinned_is_deterministic():
    wl = W.matmul(768, 1024, 1536, "bfloat16")
    prog = space_for(wl, V5E)
    s = TraceSampler(3).sample(prog)
    # replaying a complete coherent trace consumes no randomness at all
    r1 = prog.replay(s.as_dict(), TraceSampler(999).rng)
    r2 = prog.replay(s.as_dict(), TraceSampler(123).rng)
    assert r1 == s and r2 == s
    assert concretize(wl, V5E, r1) == concretize(wl, V5E, s)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 4096), n=st.integers(1, 4096), k=st.integers(1, 4096),
       dtype=st.sampled_from(["float32", "bfloat16", "int8"]),
       seed=st.integers(0, 1000))
def test_mutated_trace_replays_coherent(m, n, k, dtype, seed):
    wl = W.Workload("matmul", (m, n, k), dtype)
    prog = space_for(wl, V5E)
    smp = TraceSampler(seed)
    s = smp.sample(prog)
    mut = smp.mutate(prog, s, n_mutations=1 + seed % 3)
    p = _structurally_coherent(prog, mut)
    # deterministic: pinning the mutant's own decisions reproduces it exactly
    assert prog.replay(mut.as_dict(), TraceSampler(0).rng) == mut
    bm, bn, bk = p.block
    pm, pn, pk = p.padded_dims
    assert pm % bm == 0 and pn % bn == 0 and pk % bk == 0


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 4096), k=st.integers(1, 8192),
       seed=st.integers(0, 1000))
def test_crossed_trace_replays_coherent(n, k, seed):
    wl = W.gemv(n, k)
    prog = space_for(wl, V5E)
    smp = TraceSampler(seed)
    a, b = smp.sample(prog), smp.sample(prog)
    child = smp.crossover(prog, a, b)
    _structurally_coherent(prog, child)
    assert prog.replay(child.as_dict(), TraceSampler(0).rng) == child


def test_crossover_aligns_by_name_across_layouts():
    """The old zip()-paired crossover silently mispaired decisions when the
    parents' layouts differed (cross-hardware warm-starts; guaranteed with
    dynamic spaces). Name-aligned replay must stay coherent even crossing a
    v1 flat trace with a v2 program trace."""
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    prog = space_for(wl, V5E)
    smp = TraceSampler(5)
    v2 = smp.sample(prog)
    v1 = Schedule.fixed(variant=prog["variant"][0], m_scale=0.5, n_scale=1.0,
                        k_scale=0.25, order="nmk", accumulate=True)
    assert v1.names() != v2.names()  # genuinely different layouts
    for a, b in ((v1, v2), (v2, v1)):
        child = smp.crossover(prog, a, b)
        _structurally_coherent(prog, child)
        assert child.names() == prog.names()


def test_adopt_v1_trace_preserves_concrete_params():
    """Replay-onto-program: a v1 flat record adopts onto the program with
    bit-identical concrete kernel parameters (the Fig. 4 transfer path)."""
    from repro_torch.core import fixed_library_schedule
    for wl in (W.matmul(2048, 2048, 2048, "bfloat16"),
               W.qmatmul(512, 512, 2048), W.gemv(1024, 4096),
               W.vmacc(256, 1024)):
        prog = space_for(wl, V5E)
        fx = fixed_library_schedule(wl, V5E)
        adopted = prog.adopt(fx, TraceSampler(0).rng)
        assert adopted.version == 2
        assert concretize(wl, V5E, adopted) == concretize(wl, V5E, fx)


# ----------------------------------------------------------- v1 <-> v2 json ----

def test_v1_schedule_json_roundtrip_unchanged():
    """v1 traces keep the exact legacy wire format (a bare list), so
    databases written before the refactor stay byte-identical on re-save."""
    s = Schedule.fixed(variant="mxu_256", m_scale=0.5, accumulate=True)
    payload = s.to_json()
    assert isinstance(payload, list)
    rt = Schedule.from_json(payload)
    assert rt == s and rt.version == 1
    assert json.dumps(rt.to_json()) == json.dumps(payload)


def test_v2_schedule_json_roundtrip_with_provenance():
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_for(wl, V5E)
    s = TraceSampler(1).sample(prog)
    payload = s.to_json()
    assert isinstance(payload, dict) and payload["version"] == 2
    rt = Schedule.from_json(payload)
    assert rt == s and rt.version == 2
    assert [d.provenance for d in rt.decisions] == \
        [d.provenance for d in s.decisions]
    assert all(d.provenance == "sampled" for d in rt.decisions)
    # adopted traces record where each decision came from
    adopted = prog.adopt(Schedule.fixed(variant=s["variant"], m_scale=0.25),
                         TraceSampler(0).rng)
    provs = {d.name: d.provenance for d in adopted.decisions}
    assert provs["variant"] == "pinned"
    assert provs["bm"] == "legacy"
    assert provs["order"] == "sampled"


def test_legacy_list_json_still_decodes():
    # a record exactly as a pre-refactor database stored it
    raw = [{"name": "variant", "choice": "mxu_256",
            "candidates": ["mxu_256", "mxu_128"]},
           {"name": "m_scale", "choice": 0.5, "candidates": [1.0, 0.5, 0.25]}]
    s = Schedule.from_json(raw)
    assert s["variant"] == "mxu_256" and s["m_scale"] == 0.5
    assert s.version == 1


# ---------------------------------------------------- v1 database records ----

def _v1_database(tmp_path, wl, hw_name, latency=1e-3):
    """A database file exactly as the pre-program code wrote it."""
    sched = [{"name": "variant", "choice": "mxu_512", "candidates": []},
             {"name": "m_scale", "choice": 0.5, "candidates": [1.0, 0.5, 0.25]},
             {"name": "n_scale", "choice": 1.0, "candidates": [1.0, 0.5, 0.25]},
             {"name": "k_scale", "choice": 1.0, "candidates": [1.0, 0.5, 0.25]},
             {"name": "order", "choice": "mnk", "candidates": ["mnk", "nmk"]},
             {"name": "accumulate", "choice": True, "candidates": [True, False]}]
    key = TuningDatabase.record_key(wl, hw_name)
    payload = {"records": {key: [{"schedule": sched, "latency_s": latency,
                                  "runner": "analytic"}]},
               "workloads": {key: wl.to_json()}, "sessions": []}
    path = str(tmp_path / "v1_db.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def test_v1_database_record_dispatches(tmp_path):
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    db = TuningDatabase(_v1_database(tmp_path, wl, V5E.name))
    rec = db.best(wl, V5E.name)
    assert rec is not None and rec[1] == 1e-3
    sched, provenance = best_schedule(wl, V5E, database=db)
    assert provenance == "tuned"
    params = concretize(wl, V5E, sched)
    assert params.valid
    assert params.block == (256, 512, 512)  # legacy scale semantics intact


def test_v1_database_record_warm_starts_program_search(tmp_path):
    """A v1 record seeds a generative search: it is measured first
    (warm_started) and, adopted onto the program, bounds the final result."""
    wl = W.matmul(1024, 1024, 1024, "bfloat16")
    runner = AnalyticRunner(V5E)
    db = TuningDatabase(_v1_database(tmp_path, wl, V5E.name))
    seeds = db.transfer_candidates(wl, V5E.name)
    assert seeds and seeds[0].version == 1
    res = tune(wl, V5E, runner, trials=16, seed=0, warm_start=seeds)
    assert res.warm_started == 1
    assert res.history[0][0] == seeds[0]  # measured first, as-is
    assert res.best_latency <= runner.run(wl, seeds[0]) + 1e-15
    assert res.best_params.valid


def test_v1_near_miss_record_transfers_to_program_search(tmp_path):
    """Fig. 4 path: the v1 record is for a *neighbouring* shape; the session
    machinery must still find, measure, and exploit it."""
    prior = W.matmul(1024, 1024, 1024, "bfloat16")
    target = W.matmul(1024, 1024, 1280, "bfloat16")
    runner = AnalyticRunner(V5E)
    db = TuningDatabase(_v1_database(tmp_path, prior, V5E.name))
    seeds = db.transfer_candidates(target, V5E.name)
    assert seeds
    res = tune(target, V5E, runner, trials=16, seed=0, warm_start=seeds)
    assert res.warm_started >= 1
    assert math.isfinite(res.best_latency)


def test_database_dedups_signature_equal_schedules_across_versions():
    """Provenance tags and trace versions are not identity: re-recording the
    same decisions (e.g. a warm-start trace re-measured after adoption
    re-tagged it) must not accrete duplicate records."""
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_for(wl, V5E)
    s = TraceSampler(0).sample(prog)
    retagged = prog.replay(s.as_dict(), TraceSampler(1).rng)  # all "pinned"
    assert s == retagged and s.to_json() != retagged.to_json()
    db = TuningDatabase()
    db.add(wl, V5E.name, s, 1e-3, "analytic")
    db.add(wl, V5E.name, retagged, 1e-3, "analytic")
    db.add(wl, V5E.name, Schedule.from_json(s.to_json()), 1e-3, "analytic")
    assert len(db) == 1
    # a genuinely different measurement is still kept
    db.add(wl, V5E.name, s, 2e-3, "analytic")
    assert len(db) == 2


def test_session_report_skips_degenerate_zero_latency_sessions(tmp_path):
    from benchmarks.run import session_report
    db = TuningDatabase()
    db.add_session({"model": "m", "tuned_latency_s": 0.0,
                    "total_trials": 0})  # empty-model summary
    db.add_session({"model": "m", "tuned_latency_s": 2e-3,
                    "total_trials": 8})
    rows = session_report(db)
    names = [r[0] for r in rows]
    assert "report/m/session0" not in names  # degenerate row skipped
    assert "report/m/session1" in names
    assert any(n == "report/m/trend" for n in names)  # no ZeroDivisionError


# ----------------------------------------------- equal-budget search quality ----

def test_program_search_no_worse_than_v1_search_equal_budget(monkeypatch):
    """Same tuner, same seed, same trial budget: searching the generative
    program space must not end worse than searching the old flat space."""
    runner = AnalyticRunner(V5E)
    for dims in ((2048, 2048, 2048), (512, 2048, 2048)):
        wl = W.matmul(*dims, "bfloat16")
        v2 = tune(wl, V5E, runner, trials=48, seed=0).best_latency
        monkeypatch.setattr(
            space_lib, "space_for",
            lambda w, h: SpaceProgram.from_flat(flat_space_v1(w, h), w, h))
        v1 = tune(wl, V5E, runner, trials=48, seed=0).best_latency
        monkeypatch.undo()
        assert v2 <= v1 + 1e-12, dims


# ------------------------------------------------- sufficient-stats ridge ----

def test_cost_model_matches_batch_refit():
    """The sufficient-statistics update must reproduce the full batch refit
    (standardized ridge on log-latency) to numerical precision."""
    rng = np.random.default_rng(0)
    d = 18
    xs = [rng.standard_normal(d) * rng.uniform(0.5, 3) + rng.uniform(-2, 2)
          for _ in range(40)]
    ys = [float(np.exp(rng.standard_normal() * 0.5 - 7)) for _ in range(40)]
    cm = RidgeCostModel()
    for x, y in zip(xs, ys):
        cm.update(x, y)
    assert cm.fitted
    # reference: the pre-refactor batch computation
    x_arr = np.stack(xs)
    y_arr = np.log(np.asarray(ys))
    mu, sd = x_arr.mean(axis=0), x_arr.std(axis=0) + 1e-9
    xstd = (x_arr - mu) / sd
    a = xstd.T @ xstd + cm.l2 * np.eye(d)
    b = xstd.T @ (y_arr - y_arr.mean())
    w_ref = np.linalg.solve(a, b)
    probe = rng.standard_normal(d)
    want = float((probe - mu) / sd @ w_ref + y_arr.mean())
    np.testing.assert_allclose(cm.predict(probe), want, rtol=1e-6, atol=1e-8)


def test_cost_model_update_cost_is_flat():
    """update never touches per-sample history: its state is O(d²) no matter
    how many samples were folded in (the quadratic-session fix)."""
    cm = RidgeCostModel()
    rng = np.random.default_rng(1)
    for _ in range(500):
        cm.update(rng.standard_normal(18), float(rng.uniform(1e-6, 1e-3)))
    # no growing sample buffers anywhere in the model state
    for v in vars(cm).values():
        assert not isinstance(v, list)
    assert cm._xtx.shape == (18, 18)
    assert cm.n == 500
    assert math.isfinite(cm.predict(rng.standard_normal(18)))


def test_cost_model_still_learns_ranking_on_program_space():
    wl = W.matmul(2048, 2048, 2048, "bfloat16")
    runner = AnalyticRunner(V5E)
    prog = space_for(wl, V5E)
    smp = TraceSampler(0)
    cm = RidgeCostModel()
    pairs = []
    while len(pairs) < 32:
        s = smp.sample(prog)
        p = concretize(wl, V5E, s)
        if not p.valid:
            continue
        lat = runner.run(wl, s)
        cm.update(features(wl, V5E, p), lat)
        pairs.append((s, lat))
    pairs.sort(key=lambda r: r[1])
    best, worst = pairs[0], pairs[-1]
    if worst[1] > best[1] * 1.5:
        pb = cm.predict(features(wl, V5E, concretize(wl, V5E, best[0])))
        pw = cm.predict(features(wl, V5E, concretize(wl, V5E, worst[0])))
        assert pb < pw


# ------------------------------------------------------- session report ----

def test_session_report_tracks_per_model_trends(tmp_path):
    from benchmarks.run import session_report
    from repro_torch.core import TuningSession

    db = TuningDatabase(str(tmp_path / "db.json"))
    ops = [(2, W.matmul(256, 256, 256, "bfloat16")), (1, W.vmacc(64, 256))]
    runner = AnalyticRunner(V5E)
    TuningSession(V5E, runner, database=db).tune_model(
        ops, total_trials=12, seed=0, model="bert-tiny")
    TuningSession(V5E, runner, database=db).tune_model(
        ops, total_trials=12, seed=1, model="bert-tiny")
    TuningSession(V5E, runner, database=db).tune_model(
        [(1, W.gemv(512, 2048))], total_trials=8, seed=0, model="mlp")
    db2 = TuningDatabase(str(tmp_path / "db.json"))  # reload from disk
    assert [s["model"] for s in db2.sessions] == ["bert-tiny", "bert-tiny",
                                                  "mlp"]
    rows = session_report(db2)
    names = [r[0] for r in rows]
    assert "report/bert-tiny/session0" in names
    assert "report/bert-tiny/session1" in names
    assert "report/bert-tiny/trend" in names
    assert "report/mlp/trend" in names
    s1 = next(r for r in rows if r[0] == "report/bert-tiny/session1")
    assert "vs_prev=" in s1[2] and "baseline" not in s1[2]
    # second identical-model session warm-starts from the first: never worse
    trend = next(r for r in rows if r[0] == "report/bert-tiny/trend")
    assert "best_vs_first" in trend[2]


# --------------------------------------------- vmacc bc split (learned-era) ----

def test_vmacc_bc_split_is_kernel_gated_and_variant_conditioned():
    """The bc (column) axis is a real split: several candidates for wide c,
    every one accepted by the kernel's own block-shape capability check."""
    from repro_torch.kernels.vmacc.ops import supports_block_shape

    wl = W.vmacc(2048, 8192)
    prog = space_for(wl, V5E)
    assert prog.names() == ["variant", "br", "bc"]
    lane = V5E.lane_align(wl.dtype)
    sub = V5E.sublane_align(wl.dtype)
    for variant in prog["variant"]:
        ctx = {"variant": variant}
        ctx["br"] = prog.candidates("br", ctx)[0]
        cands = prog.candidates("bc", ctx)
        if variant == "vl_min":
            # the fallback variant keeps its single minimal-column form
            assert cands == (lane,)
            continue
        assert len(cands) >= 2  # genuinely widened vs the variant-derived bc
        for cc in cands:
            assert supports_block_shape(ctx["br"], cc, sub, lane)
            assert cc % lane == 0


def test_vmacc_bc_split_concretizes_perfect_tiles():
    """Pinned bc values flow through concretize: the padded c extent is a
    perfect multiple of the chosen block on both axes."""
    wl = W.vmacc(2048, 8192)
    prog = space_for(wl, V5E)
    smp = TraceSampler(0)
    seen_bc = set()
    for _ in range(64):
        s = smp.sample(prog)
        p = concretize(wl, V5E, s)
        seen_bc.add(p.block[1])
        assert p.block[1] == s["bc"]
        assert p.padded_dims[0] % p.block[0] == 0
        assert p.padded_dims[1] % p.block[1] == 0
    assert len(seen_bc) >= 2  # sampling actually explores the new axis


def test_vmacc_v1_trace_still_concretizes_variant_derived_bc():
    """v1 flat traces have no bc decision: the legacy path must keep
    producing the variant-derived bc, and adopt must translate them onto
    the program with identical concrete params — consuming no extra rng."""
    from repro_torch.core import fixed_library_schedule

    for wl in (W.vmacc(256, 1024), W.vmacc(2048, 2048),
               W.vmacc(96, 200), W.vmacc(1, 64)):
        prog = space_for(wl, V5E)
        fx = fixed_library_schedule(wl, V5E)
        adopted = prog.adopt(fx, TraceSampler(0).rng)
        assert adopted.get("bc") is not None  # the program trace carries it
        assert concretize(wl, V5E, adopted) == concretize(wl, V5E, fx)


# ------------------------------------- learned proposals: uniform fallback ----

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16),
       case=st.sampled_from(["matmul", "gemv", "vmacc"]))
def test_no_evidence_sampling_bit_identical_to_uniform(seed, case):
    """A fresh program (no measurements observed) must draw through exactly
    the legacy uniform rng stream: same rng.integers consumption per
    decision, so pre-learning seeds reproduce bit-identically."""
    wl = {"matmul": W.matmul(512, 2048, 2048, "bfloat16"),
          "gemv": W.gemv(2048, 8192, "bfloat16"),
          "vmacc": W.vmacc(2048, 2048)}[case]
    prog = space_for(wl, V5E)
    sampled = prog.sample(np.random.default_rng(seed)).as_dict()
    rng = np.random.default_rng(seed)  # replicate the legacy uniform loop
    ctx = {}
    for name in prog.names():
        cands = prog.candidates(name, ctx)
        ctx[name] = cands[int(rng.integers(len(cands)))]
    assert sampled == ctx
