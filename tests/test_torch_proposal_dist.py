"""Learned per-decision proposal distributions: DecisionDistribution units
(mean-reward posterior, uniform fallback, serialization), the tuner's
rank-relative feedback loop and its determinism under a scripted measurement
history, database persistence of the posteriors (old payloads stay loadable),
cross-shape distribution transfer, cost-model pretraining, and the
posterior-weighted mutation draw.

The JAX package's ``tests/test_proposal_dist.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import json
import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

from repro_torch.core import (AnalyticRunner, DecisionDistribution, RidgeCostModel,
                              Schedule, TraceSampler, TuningDatabase, TuningSession,
                              V5E, V5E_VMEM32, pretrain_from_database, space_for,
                              tune)
from repro_torch.core.cost_model import features
from repro_torch.core.tuner import TuneDriver
from repro_torch.core import workload as W


# ------------------------------------------------------- distribution units ----

def test_no_evidence_draw_is_the_uniform_integers_path():
    """With no evidence the draw must consume the rng stream exactly like
    the pre-learned ``cands[rng.integers(len(cands))]`` — bit-identical."""
    cands = ("a", "b", "c", "d", "e")
    for seed in range(20):
        d = DecisionDistribution()
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = [d.draw(cands, r1) for _ in range(10)]
        want = [cands[int(r2.integers(len(cands)))] for _ in range(10)]
        assert got == want
        # and the stream position matches afterwards too
        assert r1.integers(1 << 30) == r2.integers(1 << 30)


def test_singleton_candidate_set_consumes_one_uniform_draw():
    """Legacy replay consumed one rng.integers(1) even for singletons; the
    distribution draw must preserve that stream behaviour — with and
    without evidence on the singleton's value."""
    d = DecisionDistribution()
    d.observe("only", 0.9)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    assert d.draw(("only",), r1) == "only"
    r2.integers(1)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


def test_weights_are_uniform_without_evidence():
    d = DecisionDistribution()
    w = d.weights((1, 2, 3, 4))
    assert w == pytest.approx([0.25] * 4)


def test_mean_reward_beats_frequency():
    """A value sampled often with mediocre rewards must not outweigh a value
    sampled once with an excellent one (the mean-reward property)."""
    d = DecisionDistribution()
    for _ in range(10):
        d.observe("mediocre", 0.3)
    d.observe("excellent", 0.9)
    w = dict(zip(("mediocre", "excellent", "unseen"),
                 d.weights(("mediocre", "excellent", "unseen"))))
    assert w["excellent"] > w["unseen"] > w["mediocre"]


def test_evidence_tilts_the_draw():
    """Concentrated evidence (good value rewarded, bad value punished) must
    dominate the draw frequencies."""
    d = DecisionDistribution()
    for _ in range(50):
        d.observe("good", 1.0)
        d.observe("bad", 0.0)
    rng = np.random.default_rng(0)
    picks = [d.draw(("good", "bad"), rng) for _ in range(200)]
    assert picks.count("good") > 180


def test_invalid_rewards_are_ignored():
    d = DecisionDistribution()
    d.observe("v", float("nan"))
    d.observe("v", float("inf"))
    d.observe("v", -0.5)
    assert not d.mass and not d.count
    # so the draw still takes the uniform path
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    assert d.draw(("v", "w"), r1) == ("v", "w")[int(r2.integers(2))]


def test_entropy_normalized_and_monotone():
    d = DecisionDistribution()
    cands = (1, 2, 3, 4)
    assert d.entropy(cands) == pytest.approx(1.0)
    assert d.entropy((1,)) == 0.0
    for _ in range(30):
        d.observe(2, 1.0)
        d.observe(1, 0.0)
    assert 0.0 < d.entropy(cands) < 1.0


def test_json_roundtrip_preserves_posterior():
    d = DecisionDistribution(alpha=2.0)
    d.observe(128, 0.7)
    d.observe(128, 0.5)
    d.observe(256, 0.9)
    blob = json.loads(json.dumps(d.to_json()))  # through real JSON
    d2 = DecisionDistribution.from_json(blob)
    assert d2.alpha == 2.0
    cands = (128, 256, 512)
    assert d2.weights(cands) == pytest.approx(d.weights(cands))
    assert d2.evidence(cands) == pytest.approx(d.evidence(cands))


def test_value_keyed_evidence_remaps_onto_new_candidate_sets():
    """Evidence keyed by value participates only where the value exists —
    a shrunken/dynamic candidate set drops its weight cleanly."""
    d = DecisionDistribution()
    d.observe(512, 1.0)
    with_val = d.weights((128, 256, 512))
    without = d.weights((128, 256))
    assert with_val[2] > with_val[0]
    assert without == pytest.approx([0.5, 0.5])
    assert d.evidence((128, 256)) == 0.0


def test_seed_prior_preserves_relative_ordering():
    d = DecisionDistribution()
    d.seed_prior({128: 0.6, 256: 0.3, 512: 0.1}, strength=8.0)
    w = d.weights((128, 256, 512, 1024))
    assert w[0] > w[1] > w[2]
    assert w[3] < w[0]  # unseeded value below the strongest prior
    # degenerate priors are no-ops
    d2 = DecisionDistribution()
    d2.seed_prior({}, strength=8.0)
    d2.seed_prior({1: 0.0, 2: -1.0, 3: float("nan")}, strength=8.0)
    assert not d2.mass


# ------------------------------------------------------ program integration ----

def test_program_observe_feeds_every_decision_of_the_trace():
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_for(wl, V5E)
    s = prog.sample(np.random.default_rng(0))
    prog.observe(s, 0.8)
    d = s.as_dict()
    for name in prog.names():
        assert prog.dist(name).mass.get(d[name]) == pytest.approx(0.8)


def test_program_dists_roundtrip_and_seed_priors_change_sampling():
    wl = W.gemv(2048, 8192, "bfloat16")
    prog = space_for(wl, V5E)
    for seed in range(6):
        prog.observe(prog.sample(np.random.default_rng(seed)), 0.2 + seed / 10)
    blob = prog.dists_to_json()
    fresh = space_for(wl, V5E)
    fresh.load_dists(json.loads(json.dumps(blob)))
    assert fresh.dists_to_json() == json.loads(json.dumps(blob))
    # seeded priors move the sampled stream off the uniform one (128 is a
    # real bk candidate; a value the program never offers would be inert)
    uniform_prog = space_for(wl, V5E)
    seeded_prog = space_for(wl, V5E)
    seeded_prog.seed_priors({"bk": {128: 1.0}}, strength=50.0)
    u = [uniform_prog.sample(np.random.default_rng(s)).as_dict()
         for s in range(12)]
    p = [seeded_prog.sample(np.random.default_rng(s)).as_dict()
         for s in range(12)]
    assert u != p


def test_proposal_entropy_covers_every_decision():
    wl = W.matmul(512, 512, 512, "bfloat16")
    prog = space_for(wl, V5E)
    ent = prog.proposal_entropy()
    assert set(ent) == set(prog.names())
    assert all(0.0 <= v <= 1.0 for v in ent.values())
    # fresh program along the default prefix: multi-candidate decisions
    # report exactly uniform entropy
    assert ent["variant"] == pytest.approx(1.0)


# ----------------------------------------------------------- tuner feedback ----

def _scripted_driver(seed, latency_fn, learn=True, **kwargs):
    """Run a TuneDriver against a scripted measurement history: latency is a
    pure function of the schedule, so the whole trajectory must be a pure
    function of the seed."""
    wl = W.matmul(512, 512, 512, "bfloat16")
    driver = TuneDriver(wl, V5E, AnalyticRunner(V5E), trials=24, seed=seed,
                        learn_proposals=learn, **kwargs)
    while (batch := driver.propose()) is not None:
        driver.reconcile(batch, [latency_fn(s) for s in batch])
    return driver


def _fake_latency(s: Schedule) -> float:
    # stable across processes (unlike hash()): crc32 of the decision signature
    return 1e-6 * (1 + zlib.crc32(repr(s.signature()).encode()) % 997)


def test_fixed_seed_plus_fixed_history_replays_bit_identically():
    a = _scripted_driver(0, _fake_latency)
    b = _scripted_driver(0, _fake_latency)
    assert [s.signature() for s, _ in a.history] == \
           [s.signature() for s, _ in b.history]
    assert a.best_latency == b.best_latency
    assert a.finish().proposal_entropy == b.finish().proposal_entropy
    # and the learned posteriors agree exactly
    assert a.space.dists_to_json() == b.space.dists_to_json()


def test_rank_relative_rewards_are_scale_free():
    """Recording the same measurement sequence scaled by a constant must
    leave the learned posteriors unchanged — rank is the only signal. (Fed
    through ``_record`` directly: a full search would diverge through the
    cost model, whose log-space fit is legitimately not shift-invariant.)"""
    history = _scripted_driver(0, _fake_latency).history
    wl = W.matmul(512, 512, 512, "bfloat16")
    drivers = [TuneDriver(wl, V5E, AnalyticRunner(V5E), trials=24, seed=0)
               for _ in range(2)]
    for s, lat in history:
        drivers[0]._record(s, lat)
        drivers[1]._record(s, 1e3 * lat)
    assert drivers[0].space.dists_to_json() == \
        drivers[1].space.dists_to_json()


def test_learning_off_restores_uniform_sampler_and_reports_no_entropy():
    res = tune(W.matmul(512, 512, 512, "bfloat16"), V5E, AnalyticRunner(V5E),
               trials=16, seed=0, learn_proposals=False)
    assert res.proposal_entropy == {}
    assert math.isnan(res.mean_proposal_entropy)


def test_tune_result_carries_entropy():
    res = tune(W.matmul(512, 512, 512, "bfloat16"), V5E, AnalyticRunner(V5E),
               trials=16, seed=0)
    assert set(res.proposal_entropy) == {"variant", "bm", "bn", "bk",
                                         "order", "accumulate"}
    assert 0.0 <= res.mean_proposal_entropy <= 1.0


# -------------------------------------------------------- database and transfer ----

def test_distributions_persist_and_old_payloads_stay_loadable(tmp_path):
    path = str(tmp_path / "db.json")
    db = TuningDatabase(path)
    wl = W.matmul(512, 512, 512, "bfloat16")
    tune(wl, V5E, AnalyticRunner(V5E), trials=16, seed=0, database=db)
    assert db.get_distributions(wl, V5E.name)  # finish() stored them
    db.save()
    db2 = TuningDatabase(path)  # round-trip through disk
    assert db2.get_distributions(wl, V5E.name) == \
        json.loads(json.dumps(db.get_distributions(wl, V5E.name)))
    # a pre-learning payload without the "dist" block loads clean
    with open(path) as f:
        payload = json.load(f)
    del payload["dist"]
    old = str(tmp_path / "old.json")
    with open(old, "w") as f:
        json.dump(payload, f)
    db3 = TuningDatabase(old)
    assert db3.distributions == {}
    assert db3.best(wl, V5E.name) is not None
    assert db3.transfer_distributions(wl, V5E.name) == {}


def test_transfer_distributions_blends_same_op_only_exact_key_first():
    db = TuningDatabase()
    near = W.matmul(512, 512, 512, "bfloat16")
    far = W.matmul(4096, 4096, 4096, "bfloat16")
    other_op = W.gemv(2048, 8192, "bfloat16")
    runner = AnalyticRunner(V5E)
    for wl in (near, far, other_op):
        tune(wl, V5E, runner, trials=12, seed=0, database=db)
    target = W.matmul(600, 600, 600, "bfloat16")
    priors = db.transfer_distributions(target, V5E.name)
    assert priors  # matmul posteriors transferred
    # gemv-only decision names must not leak into a matmul prior
    assert not (set(priors) - {"variant", "bm", "bn", "bk", "order",
                               "accumulate"})
    # the exact key, when present, dominates the blend: its source weight
    # is 1/(1-(-1)) vs 1/(1+d) for any d > 0
    exact = db.transfer_distributions(near, V5E.name)
    near_vals = DecisionDistribution.from_json(
        db.get_distributions(near, V5E.name)["bm"]).mass
    top_near = max(near_vals, key=near_vals.get)
    assert exact["bm"].get(top_near, 0.0) >= priors["bm"].get(top_near, 0.0)


def test_transferred_priors_change_a_fresh_search_deterministically():
    db = TuningDatabase()
    runner = AnalyticRunner(V5E)
    tune(W.matmul(1024, 2048, 2048, "bfloat16"), V5E, runner, trials=32,
         seed=0, database=db)
    target = W.matmul(512, 2048, 2048, "bfloat16")
    priors = db.transfer_distributions(target, V5E.name)
    warm1 = tune(target, V5E, runner, trials=16, seed=1,
                 prior_distributions=priors)
    warm2 = tune(target, V5E, runner, trials=16, seed=1,
                 prior_distributions=priors)
    assert [s.signature() for s, _ in warm1.history] == \
           [s.signature() for s, _ in warm2.history]
    cold = tune(target, V5E, runner, trials=16, seed=1)
    assert [s.signature() for s, _ in warm1.history] != \
           [s.signature() for s, _ in cold.history]


def test_session_wires_priors_and_reports_entropy(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    runner = AnalyticRunner(V5E)
    ops = [(1, W.matmul(512, 512, 512, "bfloat16")), (1, W.vmacc(256, 1024))]
    ses = TuningSession(V5E, runner, database=db)
    res1 = ses.tune_model(ops, total_trials=24, seed=0, model="m")
    assert math.isfinite(res1.mean_proposal_entropy)
    assert all(math.isfinite(r.proposal_entropy) for r in res1.reports)
    stored = db.sessions[-1]
    assert isinstance(stored["proposal_entropy"], float)
    assert all(isinstance(w["proposal_entropy"], float)
               for w in stored["workloads"])
    # second session over the same model sees the stored posteriors
    assert ses._priors_for(ops[0][1])
    res2 = ses.tune_model(ops, total_trials=24, seed=0, model="m")
    assert res2.tuned_latency <= res1.tuned_latency * (1 + 1e-9)
    # learning off: priors suppressed, entropy NaN -> stored as None
    off = TuningSession(V5E, runner, database=db, learn_proposals=False)
    assert off._priors_for(ops[0][1]) is None
    off.tune_model(ops, total_trials=24, seed=0, model="m-off")
    assert db.sessions[-1]["proposal_entropy"] is None


# ---------------------------------------------------------- pretrain + mutate ----

def test_pretrain_cold_starts_the_cost_model_same_hw_only():
    db = TuningDatabase()
    wl = W.matmul(512, 512, 512, "bfloat16")
    tune(wl, V5E, AnalyticRunner(V5E), trials=16, seed=0, database=db)
    model = RidgeCostModel()
    n = pretrain_from_database(model, db, V5E)
    assert n >= model.MIN_SAMPLES and model.fitted
    # predictions track the recorded latencies' order of magnitude
    rec_s, rec_lat = db.best(wl, V5E.name)
    from repro_torch.core import concretize
    pred = model.predict(features(wl, V5E, concretize(wl, V5E, rec_s)))
    assert abs(pred - math.log(rec_lat)) < 5.0
    # records from another hardware config are not comparable: skipped
    other = RidgeCostModel()
    assert pretrain_from_database(other, db, V5E_VMEM32) == 0
    # the tune() knob goes through the same path without disturbing results
    res = tune(wl, V5E, AnalyticRunner(V5E), trials=16, seed=0, database=db,
               pretrain_cost_model=True)
    assert res.best_latency <= rec_lat * (1 + 1e-9)


def test_mutation_picks_alternatives_by_posterior_weight():
    wl = W.gemv(2048, 8192, "bfloat16")
    prog = space_for(wl, V5E)
    base = prog.sample(TraceSampler(0).rng)
    # variant-conditioned tiles can leave some sites singletons; pick the
    # first decision in the base trace with a real choice among >= 3 values
    d = next(dd for dd in base.decisions if len(dd.candidates) >= 3)
    alternatives = [c for c in d.candidates if c != d.choice]
    target, rest = alternatives[0], alternatives[1:]
    for _ in range(50):  # drive the posterior hard toward one alternative
        prog.dist(d.name).observe(target, 1.0)
        for r in rest:
            prog.dist(d.name).observe(r, 0.0)
    picks = []
    for trial in range(60):
        m = TraceSampler(trial).mutate(prog, base, n_mutations=1)
        choice = m.as_dict().get(d.name)
        if choice is not None and choice != d.choice:
            picks.append(choice)
    assert picks, "mutation never touched the evidenced site"
    assert picks.count(target) / len(picks) > 0.6
