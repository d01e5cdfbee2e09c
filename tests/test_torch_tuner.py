"""The slice as a whole against the JAX package: the tuning loop,
the tuning database and dispatch.

- On ``AnalyticRunner(V5E)`` a fixed seed must give a bit-identical
  search in both packages (history, best schedule, database records).
- A database the JAX package wrote (a gemv record included) loads in the
  port untouched, and dispatch resolves the same schedule, provenance and
  KernelParams.
- A short ``EmulateRunner`` tune on the card's design space completes, and
  its best schedule's output equals the JAX Pallas kernel's on the same
  KernelParams.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from repro import kernels as ref_kernels  # noqa: E402
from repro.core import dispatch as ref_dispatch  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import runner as ref_runner  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import tuner as ref_tuner  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402
from repro.core.database import TuningDatabase as RefDatabase  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (CPU_EMULATE, H100, V5E, AnalyticRunner,  # noqa: E402
                              CudaRunner, EmulateRunner, TuningDatabase,
                              baseline_latency, best_schedule,
                              fixed_library_schedule, kernel_params, tune)
from repro_torch.core import workload as W  # noqa: E402


def _history(res):
    return [(json.dumps(s.to_json()), lat) for s, lat in res.history]


@pytest.mark.parametrize("dims,op,dtype", [
    ((128, 256, 384), "matmul", "float32"),
    ((64, 96, 200), "qmatmul", "int8"),
    ((96, 64, 160), "matmul", "bfloat16"),
])
def test_analytic_tune_bit_identical_to_reference(dims, op, dtype):
    if op == "qmatmul":
        ref_wl, wl = ref_W.qmatmul(*dims), W.qmatmul(*dims)
    else:
        ref_wl, wl = ref_W.matmul(*dims, dtype), W.matmul(*dims, dtype)
    ref_db, db = RefDatabase(), TuningDatabase()
    theirs = ref_tuner.tune(ref_wl, ref_hw.V5E,
                            ref_runner.AnalyticRunner(ref_hw.V5E), trials=24,
                            seed=3, database=ref_db)
    ours = tune(wl, V5E, AnalyticRunner(V5E), trials=24, seed=3, database=db)
    assert _history(ours) == _history(theirs)
    assert ours.best_schedule.to_json() == theirs.best_schedule.to_json()
    assert ours.best_latency == theirs.best_latency
    assert ours.static_pruned == theirs.static_pruned
    assert ours.proposal_entropy == theirs.proposal_entropy
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert json.dumps(db.distributions) == json.dumps(ref_db.distributions)


def test_reference_database_resolves_identically(tmp_path):
    path = str(tmp_path / "db.json")
    ref_db = RefDatabase(path)
    pairs = [(ref_W.matmul(64, 128, 256), W.matmul(64, 128, 256)),
             (ref_W.qmatmul(32, 64, 96), W.qmatmul(32, 64, 96)),
             (ref_W.gemv(128, 256), W.gemv(128, 256))]
    for ref_wl, _ in pairs:
        ref_tuner.tune(ref_wl, ref_hw.V5E,
                       ref_runner.AnalyticRunner(ref_hw.V5E), trials=8,
                       seed=0, database=ref_db)
    ref_db.save()
    db = TuningDatabase(path)
    assert db.records == ref_db.records
    assert db.quarantined == {} and db.stale_quarantined == 0
    assert any(k.startswith("gemv-") for k in db.records)
    for ref_wl, wl in pairs:
        ref_s, ref_prov = ref_dispatch.best_schedule(ref_wl, ref_hw.V5E,
                                                     database=ref_db)
        s, prov = best_schedule(wl, V5E, database=db)
        assert prov == ref_prov == "tuned"
        assert s.to_json() == ref_s.to_json()
        ours, _ = kernel_params(wl, V5E, database=db)
        theirs, _ = ref_dispatch.kernel_params(ref_wl, ref_hw.V5E,
                                               database=ref_db)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    # an unseen shape: the bucketed rung, then the library schedule
    for ref_wl, wl in ((ref_W.matmul(64, 128, 320), W.matmul(64, 128, 320)),
                       (ref_W.qmatmul(8, 8, 8), W.qmatmul(8, 8, 8))):
        s, prov = best_schedule(wl, V5E, database=db)
        ref_s, ref_prov = ref_dispatch.best_schedule(ref_wl, ref_hw.V5E,
                                                     database=ref_db)
        assert (prov, s.to_json()) == (ref_prov, ref_s.to_json())
    # transfer queries read the same records the same way
    assert [s.to_json() for s in db.transfer_candidates(
        W.matmul(64, 128, 512), V5E.name)] == [
        s.to_json() for s in ref_db.transfer_candidates(
            ref_W.matmul(64, 128, 512), ref_hw.V5E.name)]


@pytest.mark.parametrize("wl", [W.qmatmul(40, 64, 96),
                                W.matmul(48, 32, 80, "float32")])
def test_emulate_tune_matches_jax_kernel(wl):
    db = TuningDatabase()
    res = tune(wl, CPU_EMULATE, EmulateRunner(CPU_EMULATE, repeats=1),
               trials=6, seed=0, database=db)
    assert res.trials == 6 and np.isfinite(res.best_latency)
    params, prov = kernel_params(wl, CPU_EMULATE, database=db)
    assert prov == "tuned" and params == res.best_params
    inputs = wl.example_inputs()
    got = kernels.build(wl, params, device="cpu")(*inputs).numpy()
    want = np.asarray(ref_kernels.build(
        wl, ref_space.KernelParams(**dataclasses.asdict(params)),
        interpret=True, cache=False)(*inputs))
    if wl.op == "qmatmul":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_dispatch_defaults_to_h100():
    wl = W.qmatmul(3136, 64, 576)
    s, prov = best_schedule(wl, database=TuningDatabase())
    assert prov == "fixed" and s == fixed_library_schedule(wl, H100)
    params, _ = kernel_params(wl, database=TuningDatabase())
    assert params.valid and params.block == (16, 64, 64)
    assert best_schedule(wl, database=TuningDatabase(),
                         allow_fixed=False) == (None, "xla")


def test_no_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        CudaRunner(H100)
    with pytest.raises(RuntimeError):
        baseline_latency(W.matmul(32, 32, 32))
    assert baseline_latency(W.matmul(32, 32, 32), device="cpu") > 0


def test_unported_paths_raise():
    """Nothing is left unported: an analytic attention tune on V5E equals
    the reference's (history and best), a deeper pipeline clamps on the
    analytic runner, the gemv space tunes, and only a CUDA runner on a TPU
    configuration raises."""
    wl, ref_wl = (W.attention(1, 9, 3, 256, 256, 64),
                  ref_W.attention(1, 9, 3, 256, 256, 64))
    ours = tune(wl, V5E, AnalyticRunner(V5E), trials=4, seed=0)
    theirs = ref_tuner.tune(ref_wl, ref_hw.V5E,
                            ref_runner.AnalyticRunner(ref_hw.V5E), trials=4,
                            seed=0)
    assert _history(ours) == _history(theirs)
    assert ours.best_latency == theirs.best_latency
    res = tune(W.matmul(32, 32, 32), V5E, AnalyticRunner(V5E), trials=4,
               pipeline_depth=2)
    assert res.pipeline_depth == 1  # the analytic runner clamps the depth
    assert np.isfinite(tune(W.gemv(32, 32), V5E, AnalyticRunner(V5E),
                            trials=4).best_latency)
    with pytest.raises(ValueError):
        CudaRunner(V5E)
