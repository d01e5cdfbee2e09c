"""The port's gemv and vmacc slice against the JAX package.

- The plain versions of ``_gemv_kernel``, ``_gemv_noacc_kernel`` and
  ``_vmacc_kernel`` against the Pallas kernels in interpret mode, on the
  same ``example_inputs(seed)`` and KernelParams, with the cases and
  tolerances of tests/test_kernels.py (gemv f32 rtol 1e-4 / atol 1e-3,
  vmacc 1e-5; the bf16 gemv case 5e-2 / 5e-1 on the float32 output).
- The gemv and vmacc design spaces on ``V5E`` and ``INTERPRET``: traces,
  coherent replay, legacy v1 traces and concretize, value for value.
- The static analyzer against exhaustive enumeration on ``H100``.
- A database the JAX package wrote with gemv and vmacc records loads in the
  port and is analysed (a stale record is quarantined, as in the
  reference), not skipped.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses
import json

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from repro import kernels as ref_kernels  # noqa: E402
from repro.core import dispatch as ref_dispatch  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import runner as ref_runner  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import static_analysis as ref_static  # noqa: E402
from repro.core import tuner as ref_tuner  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402
from repro.core.database import TuningDatabase as RefDatabase  # noqa: E402
from repro.core.sampler import TraceSampler as RefSampler  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import hardware as hw  # noqa: E402
from repro_torch.core import (H100, INTERPRET, Schedule,  # noqa: E402
                              TuningDatabase, concretize, kernel_params,
                              space_for)
from repro_torch.core import space  # noqa: E402
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.sampler import TraceSampler  # noqa: E402
from repro_torch.kernels.gemv import ops as gemv_ops  # noqa: E402
from repro_torch.kernels.gemv import plain as gemv_plain  # noqa: E402
from repro_torch.kernels.gemv.kernel import gemv_blocked  # noqa: E402
from repro_torch.kernels.vmacc import ops as vmacc_ops  # noqa: E402
from repro_torch.kernels.vmacc.kernel import vmacc_blocked  # noqa: E402

TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-1)}


def _pair(op, dims, dtype="float32"):
    """The same workload in both packages."""
    return (getattr(ref_W, op)(*dims, dtype=dtype),
            getattr(W, op)(*dims, dtype=dtype))


def _jax_params(params):
    return ref_space.KernelParams(**dataclasses.asdict(params))


def _both(port_wl, params, seed):
    """The port's plain path and the Pallas kernel in interpret mode on the
    same inputs and KernelParams, as float64 arrays."""
    assert params.valid, params.why_invalid
    inputs = port_wl.example_inputs(seed)
    want = np.asarray(ref_kernels.build(port_wl, _jax_params(params),
                                        interpret=True, cache=False)(*inputs))
    got = kernels.build(port_wl, params, device="cpu", cache=False)(*inputs)
    assert tuple(got.shape) == want.shape
    return got.double().numpy(), want.astype(np.float64), got


def _sampled(op, dims, dtype="float32", seed=0):
    """One schedule sampled by both packages' samplers from the same seed
    (they must agree), concretized on INTERPRET."""
    ref_wl, wl = _pair(op, dims, dtype)
    theirs = RefSampler(seed).sample(ref_space.space_for(ref_wl,
                                                         ref_hw.INTERPRET))
    ours = TraceSampler(seed).sample(space_for(wl, INTERPRET))
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    return wl, ours


# ------------------------------------------------------------------ gemv ----

@pytest.mark.parametrize("n,k", [(8, 8), (128, 512), (100, 300), (1, 64)])
def test_gemv_sweep_matches_pallas_interpret(n, k):
    wl, s = _sampled("gemv", (n, k))
    params = concretize(wl, INTERPRET, s)
    if not params.valid:
        pytest.skip("sampled schedule invalid for this workload")
    got, want, _ = _both(wl, params, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_both_kernels_match_pallas_interpret(dtype, accumulate):
    """``_gemv_kernel`` (accumulate) and ``_gemv_noacc_kernel`` over several
    k steps; the output is float32 for bf16 operands too."""
    wl = W.gemv(128, 512, dtype)
    bk = 64 if dtype == "float32" else 128
    params = concretize(wl, INTERPRET, Schedule.fixed(
        variant=space_for(wl, INTERPRET)["variant"][0], bn=128, bk=bk,
        accumulate=accumulate))
    assert params.accumulate is accumulate and params.grid[-1] > 1
    got, want, out = _both(wl, params, 2)
    assert out.dtype == torch.float32
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("bn_tiles", [2, 4])
def test_gemv_bn_split_matches_pallas_interpret(bn_tiles):
    """A multi-lane bn block, pinned and replayed coherently in both
    packages, lowers and computes as the reference's."""
    ref_wl, wl = _pair("gemv", (64, 96))
    lane = INTERPRET.lane_align(wl.dtype)
    bn = bn_tiles * lane
    prog = space_for(wl, INTERPRET)
    variant = next(v for v in prog["variant"] if v != "j1")
    ours = prog.replay({"variant": variant, "bn": bn}, TraceSampler(0).rng)
    theirs = ref_space.space_for(ref_wl, ref_hw.INTERPRET).replay(
        {"variant": variant, "bn": bn}, RefSampler(0).rng)
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    assert ours["bn"] == bn and gemv_ops.supports_block_shape(bn, ours["bk"],
                                                              lane)
    params = concretize(wl, INTERPRET, ours)
    assert params.block[0] == bn
    got, want, _ = _both(wl, params, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_gemv_j1_variant_matches_pallas_interpret():
    """The paper's J = 1 row kernel: the j1 variant, replayed coherently in
    both packages, is a bn = 1 block."""
    ref_wl, wl = _pair("gemv", (96, 256))
    ours = space_for(wl, INTERPRET).replay({"variant": "j1"},
                                           TraceSampler(0).rng)
    theirs = ref_space.space_for(ref_wl, ref_hw.INTERPRET).replay(
        {"variant": "j1"}, RefSampler(0).rng)
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    params = concretize(wl, INTERPRET, ours)
    assert params.block[0] == 1
    got, want, _ = _both(wl, params, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_gemv_plain_sums_block_by_block_in_k_order():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    want = torch.zeros(1, 16)
    for k0 in range(0, 64, 16):
        want += x[:, k0:k0 + 16] @ w[k0:k0 + 16]
    assert torch.equal(gemv_plain.gemv_plain(x, w, 16), want)


# ----------------------------------------------------------------- vmacc ----

@settings(max_examples=10, deadline=None)
@given(r=st.integers(1, 70), c=st.integers(1, 200), seed=st.integers(0, 3))
def test_vmacc_property_matches_pallas_interpret(r, c, seed):
    wl, s = _sampled("vmacc", (r, c), seed=seed)
    params = concretize(wl, INTERPRET, s)
    if not params.valid:
        return  # as the reference's property: nothing to compare
    got, want, out = _both(wl, params, seed)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wl", [W.gemv(24, 40), W.gemv(24, 40, "bfloat16"),
                                W.vmacc(24, 40)], ids=lambda w: w.key())
def test_gemv_vmacc_oracles_and_baselines_match_reference(wl):
    inputs = wl.example_inputs(3)
    tensors = [torch.from_numpy(a) for a in inputs]
    want = np.asarray(ref_kernels.reference(wl)(*inputs)).astype(np.float64)
    got = kernels.reference(wl)(*tensors)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    base = kernels.baseline(wl)(*tensors)
    assert base.dtype == torch.float32   # gemv: f32 result, as the kernels
    rtol, atol = TOL[wl.dtype]
    np.testing.assert_allclose(base.double().numpy(), want, rtol=rtol,
                               atol=atol)


def test_gemv_vmacc_wrappers_take_the_plain_path_only_for_cpu_tensors():
    kernels.reset_launch_counts()
    x, w = torch.ones(1, 32), torch.ones(32, 16)
    assert torch.equal(gemv_blocked(x, w, (16, 16), accumulate=False),
                       torch.full((1, 16), 32.0))
    xb, wb = x.bfloat16(), w.bfloat16()
    assert gemv_blocked(xb, wb, (1, 16)).dtype == torch.float32
    a = torch.full((16, 16), 2.0)
    assert torch.equal(vmacc_blocked(a, a, a, (16, 16)),
                       torch.full((16, 16), 6.0))
    # no kernel ran: the counts are for CUDA launches only
    assert set(kernels.launch_counts().values()) == {0}
    assert {"_gemv_kernel", "_gemv_noacc_kernel",
            "_vmacc_kernel"} <= set(kernels.launch_counts())
    with pytest.raises(ValueError):
        gemv_blocked(x.to("meta"), w.to("meta"), (16, 16))
    with pytest.raises(ValueError):
        gemv_blocked(x, w, (16, 24))                 # does not tile k
    with pytest.raises(ValueError):
        gemv_blocked(torch.ones(2, 32), w, (16, 16))  # not a vector
    with pytest.raises(ValueError):
        gemv_blocked(x, wb, (16, 16))                 # mixed dtypes
    with pytest.raises(ValueError):
        vmacc_blocked(a, a, a.t().contiguous()[:8], (8, 16))
    with pytest.raises(ValueError):
        vmacc_blocked(a, a, a.double(), (16, 16))
    with pytest.raises(ValueError):
        vmacc_blocked(a, a, a, (16, 24))


# ---------------------------------------------------------- design space ----

SPACE_CASES = [("gemv", (128, 512), "float32"),
               ("gemv", (100, 300), "bfloat16"),
               ("gemv", (1, 64), "float32"),
               ("gemv", (1000, 1280), "bfloat16"),
               ("vmacc", (24, 300), "float32"),
               ("vmacc", (196, 192), "float32"),
               ("vmacc", (49, 960), "float32")]
TPU_CONFIGS = ["tpu_v5e", "cpu_interpret"]


@pytest.mark.parametrize("name", TPU_CONFIGS)
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES)
def test_space_and_concretize_match_reference(name, op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    ref_prog = ref_space.space_for(ref, ref_hw.get(name))
    prog = space_for(port, hw.get(name))
    assert prog.names() == ref_prog.names()
    traces = list(prog.traces(limit=3000))
    assert traces == list(ref_prog.traces(limit=3000))
    for t in traces[::3]:
        for ins_name in prog.names():
            assert prog.candidates(ins_name, t) == \
                ref_prog.candidates(ins_name, t)
        ours = concretize(port, hw.get(name), Schedule.fixed(**t))
        theirs = ref_space.concretize(ref, ref_hw.get(name),
                                      ref_schedule.Schedule.fixed(**t))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert space.instruction_census(port, ours) == \
            ref_space.instruction_census(ref, theirs)
        assert space.hbm_traffic_bytes(port, ours) == \
            ref_space.hbm_traffic_bytes(ref, theirs)


@pytest.mark.parametrize("name", TPU_CONFIGS)
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES)
def test_replay_matches_reference(name, op, dims, dtype):
    """Coherent replay of a partly pinned trace draws the same completion
    from the same seed in both packages."""
    ref, port = _pair(op, dims, dtype)
    prog = space_for(port, hw.get(name))
    ref_prog = ref_space.space_for(ref, ref_hw.get(name))
    for seed, variant in enumerate(prog["variant"]):
        ours = prog.replay({"variant": variant}, TraceSampler(seed).rng)
        theirs = ref_prog.replay({"variant": variant}, RefSampler(seed).rng)
        assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())


@pytest.mark.parametrize("name", TPU_CONFIGS)
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES)
def test_legacy_v1_traces_concretize_identically(name, op, dims, dtype):
    """v1 traces (variant plus *_scale knobs, no bn/bc split): the
    ``legacy_bn`` / ``legacy_bc`` hooks reproduce the reference's blocks."""
    ref, port = _pair(op, dims, dtype)
    for v in ref_space.space_for(ref, ref_hw.get(name))["variant"]:
        for scale in (0.25, 1.0):
            if op == "gemv":
                v1 = dict(variant=v, k_scale=scale, accumulate=False)
            else:
                v1 = dict(variant=v, r_scale=scale)
            ours = concretize(port, hw.get(name), Schedule.fixed(**v1))
            theirs = ref_space.concretize(ref, ref_hw.get(name),
                                          ref_schedule.Schedule.fixed(**v1))
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", TPU_CONFIGS)
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES[:2] + SPACE_CASES[4:6])
def test_feasibility_matches_reference(name, op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    theirs = ref_static.feasibility(ref, ref_hw.get(name))
    ours = static_analysis.feasibility(port, hw.get(name))
    assert (ours.exhaustive, ours.total_traces, ours.valid_traces,
            ours.vmem_floor) == (theirs.exhaustive, theirs.total_traces,
                                 theirs.valid_traces, theirs.vmem_floor)
    assert ours.feasible == theirs.feasible and ours.seen == theirs.seen
    assert [str(d) for d in ours.diagnostics] == \
        [str(d) for d in theirs.diagnostics]


# ------------------------------------------------ H100: analyzer and gate ----

H100_CASES = [W.gemv(32000, 576, "bfloat16"), W.gemv(960, 576, "bfloat16"),
              W.gemv(576, 1536, "bfloat16"),   # MobileLLM-125M's down proj
              W.gemv(100, 300), W.gemv(1, 64), W.vmacc(12544, 32),
              W.vmacc(49, 960), W.vmacc(33, 17)]


@pytest.mark.parametrize("wl", H100_CASES, ids=lambda w: w.key())
def test_h100_analyzer_matches_exhaustive_enumeration(wl):
    """The static report's counts and feasible sets equal those of running
    every trace through concretize and the postprocessors (the launch gate
    among them)."""
    report = static_analysis.analyze(wl, H100)
    assert report.exhaustive and report.valid_traces > 0
    prog = space_for(wl, H100)
    total = valid = 0
    feasible = {ins.name: set() for ins in prog.instructions}
    for t in prog.traces(limit=static_analysis.DEFAULT_TRACE_LIMIT):
        total += 1
        if prog.validate(Schedule.fixed(**t)).valid:
            valid += 1
            for k, v in t.items():
                feasible[k].add(v)
    assert (report.total_traces, report.valid_traces) == (total, valid)
    for name, vals in feasible.items():
        assert set(report.feasible[name]) == vals, name


@pytest.mark.parametrize("wl", H100_CASES, ids=lambda w: w.key())
def test_h100_space_only_offers_launchable_blocks(wl):
    lane, sub = H100.lane_align(wl.dtype), H100.sublane_align(wl.dtype)
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        if wl.op == "gemv":
            ok = gemv_ops.supports_block_shape(*p.block, lane)
        else:
            ok = vmacc_ops.supports_block_shape(*p.block, sub, lane)
        assert ok, (t, p.block)


@pytest.mark.parametrize("op,block,inside", [
    ("gemv", (gemv_ops.MAX_BN, 16), True),
    ("gemv", (gemv_ops.MAX_BN + 16, 16), False),   # threads per block
    ("gemv", (16, 16), True), ("gemv", (16, 24), False),     # bk lane
    ("gemv", (1, 16), True), ("gemv", (8, 16), False),       # bn: 1 or lane
    ("vmacc", (16, 16), True), ("vmacc", (8, 16), False),    # br sublane
    ("vmacc", (16, 32), True), ("vmacc", (16, 24), False),   # bc lane
])
def test_h100_launch_gate_on_both_sides(op, block, inside):
    """The launch-gate postprocessor rejects exactly what the kernel's gate
    rejects, on the card's configuration only."""
    if op == "gemv":
        wl = W.gemv(2 * gemv_ops.MAX_BN + 32, 48)
        assert gemv_ops.supports_block_shape(*block, 16) is inside
        decisions = dict(variant="vl_16", bn=block[0], bk=block[1],
                         accumulate=True)
    else:
        wl = W.vmacc(96, 48)
        assert vmacc_ops.supports_block_shape(*block, 16, 16) is inside
        decisions = dict(variant="vl_min", br=block[0], bc=block[1])
    params = concretize(wl, H100, Schedule.fixed(**decisions))
    assert params.valid is inside, params.why_invalid
    if block[0] > gemv_ops.MAX_BN:   # only the kernel's own limit binds
        assert "not launchable" in params.why_invalid


def test_h100_ladders_unchanged():
    """For bf16 the gemv ladder is vl_2048 ... vl_16 plus j1 and vmacc's
    vl_64x128 ... vl_16x128 plus vl_min (f32: one rung fewer each)."""
    from repro_torch.core import intrinsics

    def names(op, dtype):
        return [v.name for v in intrinsics.all_variants(op, H100, dtype)]

    gemv = [f"vl_{2048 >> i}" for i in range(8)] + ["j1"]
    assert names("gemv", "bfloat16") == gemv
    assert names("gemv", "float32") == gemv[1:]
    vmacc = ["vl_64x128", "vl_32x128", "vl_16x128", "vl_min"]
    assert names("vmacc", "bfloat16") == vmacc
    assert names("vmacc", "float32") == vmacc[1:]


# ------------------------------------------- reference-written database ----

def test_reference_database_with_gemv_and_vmacc_is_analysed(tmp_path):
    """Records the JAX package wrote for gemv and vmacc are verified at
    load (a stale one is quarantined exactly as the reference does), and
    dispatch resolves the same schedule and KernelParams."""
    path = str(tmp_path / "db.json")
    ref_db = RefDatabase(path)
    pairs = [_pair("gemv", (256, 512), "bfloat16"), _pair("vmacc", (64, 256))]
    for ref_wl, _ in pairs:
        ref_tuner.tune(ref_wl, ref_hw.V5E,
                       ref_runner.AnalyticRunner(ref_hw.V5E), trials=8,
                       seed=1, database=ref_db)
        # a stale record: its variant left the ladder; better latency
        ref_db.add(ref_wl, ref_hw.V5E.name,
                   ref_schedule.Schedule.fixed(variant="vl_9999"), 1e-12,
                   "analytic")
    ref_db.save()
    ref_loaded = RefDatabase(path)
    db = TuningDatabase(path)
    assert ref_loaded.stale_quarantined == 2
    assert db.stale_quarantined == 2
    assert json.dumps(db.quarantined, sort_keys=True) == \
        json.dumps(ref_loaded.quarantined, sort_keys=True)
    assert db.records == ref_loaded.records
    for ref_wl, wl in pairs:
        assert db._static_report_for_key(
            TuningDatabase.record_key(wl, hw.V5E.name)) is not None
        ref_s, ref_prov = ref_dispatch.best_schedule(ref_wl, ref_hw.V5E,
                                                     database=ref_loaded)
        params, prov = kernel_params(wl, hw.V5E, database=db)
        assert prov == ref_prov == "tuned"
        assert dataclasses.asdict(params) == dataclasses.asdict(
            ref_space.concretize(ref_wl, ref_hw.V5E, ref_s))
