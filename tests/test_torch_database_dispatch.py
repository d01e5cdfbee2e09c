"""Database bugfixes (env re-resolution, hot-swap reload, atomic save,
strict JSON, non-finite latency rejection) and the serving-path dispatch
cache with invalidation.

The JAX package's ``tests/test_database_dispatch.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

from repro_torch.core import (Schedule, TuningDatabase, V5E, best_schedule,
                              fixed_library_schedule)
from repro_torch.core import workload as W
from repro_torch.core.database import global_database, reset_global_database


@pytest.fixture
def fresh_global():
    reset_global_database()
    yield
    reset_global_database()


def _make_db_file(path, wl, variant, latency):
    # load() statically verifies records, so on-disk fixtures must carry a
    # real variant — artifacts are told apart by latency below instead
    db = TuningDatabase(str(path))
    db.add(wl, V5E.name, Schedule.fixed(variant=variant), latency, "analytic")
    db.save()


# ------------------------------------------------------- global database ----

def test_global_database_reresolves_env_var(tmp_path, monkeypatch,
                                            fresh_global):
    """Repointing REPRO_TUNING_DB at a new tuned artifact must take effect
    in a live process — the first-seen value is no longer pinned."""
    wl = W.matmul(64, 64, 64)
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    _make_db_file(p1, wl, "mxu_min", 1e-3)
    _make_db_file(p2, wl, "mxu_min", 2e-3)

    monkeypatch.setenv("REPRO_TUNING_DB", str(p1))
    db1 = global_database()
    assert db1.path == str(p1)
    assert db1.best(wl, V5E.name)[1] == 1e-3
    assert global_database() is db1  # same path -> cached instance

    monkeypatch.setenv("REPRO_TUNING_DB", str(p2))
    db2 = global_database()
    assert db2.path == str(p2)
    assert db2.best(wl, V5E.name)[1] == 2e-3


def test_reset_global_database_rereads_disk(tmp_path, monkeypatch,
                                            fresh_global):
    wl = W.matmul(32, 32, 32)
    p = tmp_path / "db.json"
    _make_db_file(p, wl, "mxu_min", 1e-3)
    monkeypatch.setenv("REPRO_TUNING_DB", str(p))
    assert global_database().best(wl, V5E.name)[1] == 1e-3
    # another process ships a better artifact to the same path
    _make_db_file(p, wl, "mxu_min", 5e-4)
    reset_global_database()
    assert global_database().best(wl, V5E.name)[1] == 5e-4


def test_global_database_loads_file_created_after_first_call(tmp_path,
                                                             monkeypatch,
                                                             fresh_global):
    """A tuning run saving its artifact mid-process must become visible to
    dispatch: the instance used to be pinned to 'no file' forever."""
    wl = W.matmul(64, 64, 64)
    p = tmp_path / "db.json"
    monkeypatch.setenv("REPRO_TUNING_DB", str(p))
    assert global_database().best(wl, V5E.name) is None  # no file yet
    _make_db_file(p, wl, "mxu_min", 1e-3)  # appears after the first call
    assert global_database().best(wl, V5E.name)[1] == 1e-3


def test_global_database_hot_swaps_on_mtime_change(tmp_path, monkeypatch,
                                                   fresh_global):
    """A changed artifact reloads *in place*: callers holding the instance
    (a running server) see the new records without any reset call."""
    wl = W.matmul(64, 64, 64)
    p = tmp_path / "db.json"
    _make_db_file(p, wl, "mxu_min", 1e-3)
    monkeypatch.setenv("REPRO_TUNING_DB", str(p))
    db = global_database()
    assert db.best(wl, V5E.name)[1] == 1e-3
    _make_db_file(p, wl, "mxu_min", 5e-4)  # tuner ships a better artifact
    assert global_database() is db  # same instance, reloaded in place
    assert db.best(wl, V5E.name)[1] == 5e-4


# ----------------------------------------------------------- persistence ----

def test_add_rejects_nonfinite_latency():
    db = TuningDatabase()
    wl = W.vmacc(8, 8)
    db.add(wl, "hw", Schedule.fixed(variant="a"), float("inf"), "r")
    db.add(wl, "hw", Schedule.fixed(variant="b"), float("nan"), "r")
    assert len(db) == 0
    assert db.best(wl, "hw") is None
    db.add(wl, "hw", Schedule.fixed(variant="c"), 1e-3, "r")
    assert len(db) == 1


def test_failed_save_leaks_no_temp_file(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    db.add(W.vmacc(8, 8), "hw", Schedule.fixed(variant="a"), 1e-3, "r")
    db.sessions.append({"bad": object()})  # unserializable mid-payload
    with pytest.raises(TypeError):
        db.save()
    assert os.listdir(tmp_path) == []  # no db.json, and no mkstemp orphan


def test_add_session_sanitizes_nonfinite_to_strict_json(tmp_path):
    db = TuningDatabase(str(tmp_path / "db.json"))
    db.add_session({"speedup_vs_fixed": float("nan"),
                    "workloads": [{"best_latency_s": float("inf")}],
                    "wall_time_s": 1.5})
    db.save()
    with open(db.path) as f:
        payload = json.load(f)  # strict parse: no Infinity/NaN tokens
    assert payload["sessions"][0]["speedup_vs_fixed"] is None
    assert payload["sessions"][0]["workloads"][0]["best_latency_s"] is None
    assert payload["sessions"][0]["wall_time_s"] == 1.5


# ------------------------------------------------- non-finite latencies ----

def test_best_skips_negative_infinity():
    """-inf passed the old `!= inf` filter and won every min() forever."""
    db = TuningDatabase()
    wl = W.matmul(64, 64, 64)
    db.add(wl, V5E.name, Schedule.fixed(variant="good"), 1e-3, "analytic")
    # add() rejects non-finite, so corruption is injected directly — the
    # shape a hand-edited or hostile loaded payload takes
    key = db.record_key(wl, V5E.name)
    db.records[key].append({"schedule": Schedule.fixed(variant="evil")
                            .to_json(),
                            "latency_s": float("-inf"), "runner": "r"})
    db._best_cache.clear()
    sched, latency = db.best(wl, V5E.name)
    assert sched["variant"] == "good" and latency == 1e-3


def test_transfer_candidates_skip_negative_infinity():
    db = TuningDatabase()
    query = W.matmul(64, 64, 64)
    other = W.matmul(64, 64, 128)  # same op family, near shape
    good = Schedule.fixed(variant="mxu_min")
    # statically valid decisions, so only the finite filter can stop it
    evil = Schedule.fixed(variant="mxu_min", m_scale=0.25, n_scale=1.0,
                          k_scale=1.0, order="mnk", accumulate=True)
    db.add(other, V5E.name, good, 1e-3, "analytic")
    key = db.record_key(other, V5E.name)
    db.records[key].append({"schedule": evil.to_json(),
                            "latency_s": float("-inf"), "runner": "r"})
    out = db.transfer_candidates(query, V5E.name)
    assert [s.signature() for s in out] == [good.signature()]


def test_load_quarantines_nonfinite_latencies(tmp_path):
    """json.load parses -Infinity, so a hand-edited artifact could smuggle
    a record that wins every best() — load() must quarantine it."""
    wl = W.matmul(64, 64, 64)
    key = TuningDatabase.record_key(wl, V5E.name)
    payload = {
        "records": {key: [
            {"schedule": Schedule.fixed(variant="mxu_min").to_json(),
             "latency_s": 1e-3, "runner": "analytic"},
            {"schedule": Schedule.fixed(variant="mxu_min").to_json(),
             "latency_s": float("-inf"), "runner": "analytic"},
            {"schedule": Schedule.fixed(variant="mxu_min").to_json(),
             "latency_s": float("nan"), "runner": "analytic"},
        ]},
        "workloads": {key: wl.to_json()},
    }
    p = tmp_path / "edited.json"
    with open(p, "w") as f:
        json.dump(payload, f)  # default allow_nan: writes -Infinity/NaN
    db = TuningDatabase(str(p))
    assert db.best(wl, V5E.name)[1] == 1e-3
    reasons = [q["reason"] for q in db.quarantined[key]]
    assert sum("non-finite latency" in r for r in reasons) == 2


def test_transfer_candidates_skip_cross_rank_records():
    """Rank-mismatched (infinite-distance) same-op records can never
    concretize on the target; transfer must skip them like
    transfer_distributions does, not pad the warm-start list."""
    query = W.matmul(64, 64, 64)
    db = TuningDatabase()
    # a corrupt same-op entry whose dims lost a rank (hand-edited file)
    bad_key = "matmul-64x64-corrupt@" + V5E.name
    db.workloads[bad_key] = {"op": "matmul", "dims": [64, 64],
                             "dtype": "float32"}
    db.records[bad_key] = [{"schedule":
                            Schedule.fixed(variant="mxu_min").to_json(),
                            "latency_s": 1e-3, "runner": "r"}]
    assert db.transfer_candidates(query, V5E.name) == []


# --------------------------------------------------------- dispatch cache ----

def test_best_is_memoized_and_invalidated_by_add():
    db = TuningDatabase()
    wl = W.matmul(128, 128, 128, "bfloat16")
    db.add(wl, V5E.name, Schedule.fixed(variant="first"), 2e-3, "analytic")
    b1 = db.best(wl, V5E.name)
    assert db.best(wl, V5E.name) is b1  # cached object, no re-parse
    db.add(wl, V5E.name, Schedule.fixed(variant="better"), 1e-3, "analytic")
    b2 = db.best(wl, V5E.name)
    assert b2 is not b1 and b2[0]["variant"] == "better"  # invalidated


def test_best_cache_invalidated_by_load(tmp_path):
    wl = W.matmul(64, 64, 64)
    p = tmp_path / "db.json"
    _make_db_file(p, wl, "mxu_min", 1e-3)
    db = TuningDatabase()
    assert db.best(wl, V5E.name) is None  # miss is cached too
    db.load(str(p))
    assert db.best(wl, V5E.name)[0]["variant"] == "mxu_min"


def test_dispatch_provenance_flips_on_database_write():
    db = TuningDatabase()
    wl = W.matmul(256, 256, 256, "bfloat16")
    s, prov = best_schedule(wl, V5E, database=db)
    assert prov == "fixed"
    db.add(wl, V5E.name, Schedule.fixed(variant="tuned_one"), 1e-3,
           "analytic")
    s, prov = best_schedule(wl, V5E, database=db)
    assert prov == "tuned" and s["variant"] == "tuned_one"


def test_fixed_library_schedule_is_memoized():
    wl = W.qmatmul(64, 64, 64)
    assert fixed_library_schedule(wl, V5E) is fixed_library_schedule(wl, V5E)
    # distinct hardware -> distinct cache entry, not a collision
    from repro_torch.core import V5E_MXU256
    assert fixed_library_schedule(wl, V5E_MXU256) is not \
        fixed_library_schedule(wl, V5E)
