"""The port's attention slice against the JAX package.

- The oracle (``flash_attention/ref.py``) against the reference's
  ``attention_ref`` at 1e-5, and the plain version of ``_fa_kernel`` (the
  CPU path of ``kernels.build``) against the Pallas kernel in interpret
  mode at 2e-3 (tests/test_kernels.py:141), on the same
  ``example_inputs(seed)`` and KernelParams: the test_kernels.py sweep, every
  registered variant of one workload, and the causal ``q_len > kv_len``
  case on all rows.
- The reference quirk the port keeps: rows with no visible key follow the
  kernel (skipped blocks, padded tail counted), not the oracle.
- The attention design space: ``concretize`` on ``V5E``, ``V5E_VMEM32``
  and ``INTERPRET`` value for value, static feasibility on ``V5E``, and on
  ``H100`` the kernel's own shared memory and launch gate.
- The slice as a whole: analytic ``TuningSession`` runs over BERT-tiny and
  MobileLLM-125M int8 prefill, bit-identical to the JAX package's, serial
  and interleaved at depth 2; a database the JAX package wrote with
  attention records loads and is quarantined as the reference does.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from benchmarks import nets as ref_nets  # noqa: E402
from repro import kernels as ref_kernels  # noqa: E402
from repro.core import AnalyticRunner as RefAnalytic  # noqa: E402
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import TuningSession as RefSession  # noqa: E402
from repro.core import dispatch as ref_dispatch  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import static_analysis as ref_static  # noqa: E402
from repro.core import tuner as ref_tuner  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402
from repro.core.sampler import TraceSampler as RefSampler  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402

from _test_runners import SlowAnalytic as RefSlowAnalytic  # noqa: E402
from _torch_test_runners import SlowAnalytic  # noqa: E402

from repro_torch import kernels, nets  # noqa: E402
from repro_torch.core import hardware as hw  # noqa: E402
from repro_torch.core import (H100, INTERPRET, V5E, AnalyticRunner,  # noqa: E402
                              Schedule, TuningDatabase, TuningSession,
                              concretize, fixed_library_schedule,
                              kernel_params, space_for)
from repro_torch.core import space  # noqa: E402
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.sampler import TraceSampler  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_blocked  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

TOL = 2e-3   # tests/test_kernels.py:141

# tests/test_kernels.py:131-146: the causal sweep, then the non-causal case
SWEEP = [((1, 2, 2, 32, 32, 16), True),     # MHA
         ((2, 4, 2, 64, 64, 32), True),     # GQA group 2
         ((1, 8, 1, 48, 48, 64), True),     # MQA, ragged seq
         ((1, 2, 1, 17, 33, 8), True),      # non-aligned, cross lengths
         ((2, 2, 2, 24, 40, 16), False)]
# causal with q_len > kv_len: q rows 0-15 see no key (offset = -16)
NO_KEY = ((1, 2, 1, 33, 17, 8), True)
# q times this peaks the attention: example_inputs' operands (standard
# deviation 0.5) give scores of standard deviation 0.25, near-uniform
# weights; 16x gives 4, so the running max moves between KV blocks.
Q_SHARP = 16.0


def _pair(dims, causal, dtype="float32"):
    """The same workload in both packages."""
    return (ref_W.attention(*dims, dtype, causal=causal),
            W.attention(*dims, dtype, causal=causal))


def _jax_params(params):
    return ref_space.KernelParams(**dataclasses.asdict(params))


def _both(wl, params, seed, q_scale=1.0):
    """The port's kernel path (plain version, on the CPU) and the Pallas
    kernel in interpret mode on the same inputs (q scaled by ``q_scale``)
    and KernelParams."""
    assert params.valid, params.why_invalid
    q, k, v = wl.example_inputs(seed)
    inputs = (q * np.float32(q_scale), k, v)
    want = np.asarray(ref_kernels.build(wl, _jax_params(params),
                                        interpret=True, cache=False)(*inputs))
    got = kernels.build(wl, params, device="cpu", cache=False)(*inputs)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    return got.double().numpy(), want.astype(np.float64), inputs


def _oracles(wl, inputs):
    causal = "causal" in wl.tags
    theirs = np.asarray(jax_attention_ref(*inputs, causal=causal))
    ours = attention_ref(*map(torch.from_numpy, inputs), causal=causal)
    return ours.double().numpy(), theirs.astype(np.float64)


# ------------------------------------------------------------ numerics ----

@pytest.mark.parametrize("dims,causal", SWEEP + [NO_KEY])
def test_oracle_matches_reference(dims, causal):
    _, wl = _pair(dims, causal)
    ours, theirs = _oracles(wl, wl.example_inputs(0))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims,causal", SWEEP + [NO_KEY])
def test_plain_matches_pallas_interpret(dims, causal):
    """A schedule both packages' samplers draw from seed 0 on INTERPRET
    (they must agree), all rows compared."""
    ref_wl, wl = _pair(dims, causal)
    theirs = RefSampler(0).sample(ref_space.space_for(ref_wl,
                                                      ref_hw.INTERPRET))
    ours = TraceSampler(0).sample(space_for(wl, INTERPRET))
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    got, want, _ = _both(wl, concretize(wl, INTERPRET, ours), 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dims,causal", [((1, 2, 1, 40, 40, 16), True),
                                         ((2, 2, 2, 24, 40, 16), False),
                                         NO_KEY])
def test_peaked_scores_match_pallas_interpret(dims, causal):
    """Peaked attention through the smallest rung (many KV blocks per row):
    the alpha rescale and the exp path, not a near-mean of v, carry the
    result."""
    _, wl = _pair(dims, causal)
    params = concretize(wl, INTERPRET, Schedule.fixed(variant="fa_8x8"))
    got, want, _ = _both(wl, params, 1, Q_SHARP)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bkv", [64, 32, 16, 8])
@pytest.mark.parametrize("bq", [64, 32, 16, 8])
def test_every_variant_matches_pallas_interpret(bq, bkv):
    """Every registered (block_q, block_kv) rung of INTERPRET's ladder (the
    port's test_attention_all_variants_agree)."""
    _, wl = _pair((1, 2, 1, 40, 40, 16), True)
    name = f"fa_{bq}x{bkv}"
    assert name in space_for(wl, INTERPRET)["variant"]
    got, want, _ = _both(wl, concretize(wl, INTERPRET,
                                        Schedule.fixed(variant=name)), 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", ["fa_8x8", "fa_64x64"])
def test_rows_with_no_visible_key_follow_the_kernel(variant):
    """attention(1, 2, 1, 33, 17, 8) causal: offset = -16, so q rows 0-15
    see no key. The port's kernel path equals Pallas on every row, and both
    differ from the two oracles on exactly rows 0-15: at fa_8x8 those rows'
    blocks are all skipped (l = 0, output 0); at fa_64x64 the one live
    block averages its 24 v rows, the 7 padded ones included, where the
    oracles average the 17 real ones."""
    _, wl = _pair(*NO_KEY)
    params = concretize(wl, INTERPRET, Schedule.fixed(variant=variant))
    got, want, inputs = _both(wl, params, 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for oracle in _oracles(wl, inputs):
        row_diff = np.abs(got - oracle).max(axis=(0, 1, 3))
        assert np.nonzero(row_diff > TOL)[0].tolist() == list(range(16))
    if variant == "fa_8x8":
        assert not got[:, :, :16].any()


def test_wrapper_takes_the_plain_path_only_for_cpu_tensors():
    _, wl = _pair((1, 4, 2, 16, 16, 8), True)
    params = concretize(wl, H100, Schedule.fixed(variant="fa_16x16"))
    q, k, v = (torch.ones(4, 16, 16), torch.ones(2, 16, 16),
               torch.ones(2, 16, 16))
    kernels.reset_launch_counts()
    assert torch.equal(flash_attention_blocked(q, k, v, params),
                       torch.ones(4, 16, 16))
    assert kernels.launch_counts()["_fa_kernel"] == 0   # CUDA launches only
    with pytest.raises(ValueError):
        flash_attention_blocked(q.to("meta"), k.to("meta"), v.to("meta"),
                                params)
    with pytest.raises(ValueError):                  # k heads do not match
        flash_attention_blocked(q, torch.ones(4, 16, 16),
                                torch.ones(4, 16, 16), params)
    with pytest.raises(ValueError):                  # mixed dtypes
        flash_attention_blocked(q, k.bfloat16(), v, params)
    with pytest.raises(ValueError):                  # not contiguous
        flash_attention_blocked(q.transpose(1, 2), k, v, params)


@pytest.mark.parametrize("dims,causal", [SWEEP[1], SWEEP[3], SWEEP[4],
                                         NO_KEY])
def test_library_call_matches_oracle(dims, causal):
    """``kernels.baseline``: SDPA, with the bottom-right causal mask where
    the lengths differ; the oracle's no-visible-key rows (a uniform
    average) included."""
    _, wl = _pair(dims, causal)
    inputs = tuple(map(torch.from_numpy, wl.example_inputs(1)))
    want = kernels.reference(wl)(*inputs)
    torch.testing.assert_close(kernels.baseline(wl)(*inputs), want,
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- design space ----

SPACE_CASES = [((1, 4, 2, 16, 16, 8), True),
               ((1, 9, 3, 64, 64, 64), True),      # MobileLLM-125M prefill
               ((1, 2, 2, 64, 64, 64), False),     # BERT-tiny
               ((1, 2, 1, 33, 17, 8), True),
               ((1, 9, 3, 2048, 2048, 64), True)]  # MobileLLM at max seq


@pytest.mark.parametrize("name", ["tpu_v5e", "tpu_v5e_vmem32",
                                  "cpu_interpret"])
@pytest.mark.parametrize("dims,causal", SPACE_CASES)
def test_concretize_matches_reference(name, dims, causal):
    ref, port = _pair(dims, causal)
    ref_prog = ref_space.space_for(ref, ref_hw.get(name))
    prog = space_for(port, hw.get(name))
    assert prog.names() == ref_prog.names() == ["variant"]
    assert prog["variant"] == ref_prog["variant"]
    for v in prog["variant"]:
        ours = concretize(port, hw.get(name), Schedule.fixed(variant=v))
        theirs = ref_space.concretize(ref, ref_hw.get(name),
                                      ref_schedule.Schedule.fixed(variant=v))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert space.instruction_census(port, ours) == \
            ref_space.instruction_census(ref, theirs)
        assert space.hbm_traffic_bytes(port, ours) == \
            ref_space.hbm_traffic_bytes(ref, theirs)
    assert fixed_library_schedule(port, hw.get(name)).to_json() == \
        ref_dispatch.fixed_library_schedule(ref, ref_hw.get(name)).to_json()


@pytest.mark.parametrize("dims,causal", SPACE_CASES)
def test_h100_footprint_is_the_kernels_shared_memory(dims, causal):
    """On the card's configuration ``vmem_bytes`` is what the kernel asks
    for, and no rung of the ladder is refused at head dim 64 or below."""
    _, wl = _pair(dims, causal)
    names = space_for(wl, H100)["variant"]
    assert len(names) == 16 and names[0] == "fa_128x128"
    for v in names:
        p = concretize(wl, H100, Schedule.fixed(variant=v))
        bq, bkv = p.block
        assert p.vmem_bytes == fa_ops.smem_bytes(bq, bkv, p.padded_dims[5],
                                                 wl.dtype)
        assert p.vmem_bytes == space.attention_block_bytes(
            wl, H100, bq, bkv, p.padded_dims[5])
        assert p.valid, (v, p.why_invalid)
    # the library schedule falls to names[0]: fa_256x256 is not on the ladder
    fixed = concretize(wl, H100, fixed_library_schedule(wl, H100))
    assert fixed_library_schedule(wl, H100).as_dict() == \
        {"variant": "fa_128x128"} and fixed.valid


@pytest.mark.parametrize("dtype,pd,inside", [
    ("float32", 80, True), ("float32", 96, False),
    ("bfloat16", 160, True), ("bfloat16", 176, False),
])
def test_h100_launch_gate_rejects_what_does_not_fit(dtype, pd, inside):
    """fa_128x128 at a head dim whose shared memory crosses the H100's
    232,448 bytes (the q tile and a two-stage k/v ring, rows of pd values
    plus 16 bytes: 640 rows of 336 bytes fit, of 400 do not): refused by
    the gate (so INVALID), and only on the card's configuration."""
    assert fa_ops.supports_block_shape(128, 128, pd, dtype,
                                       H100.vmem_capacity) is inside
    assert (fa_ops.smem_bytes(128, 128, pd, dtype) <= 232_448) is inside
    wl = W.attention(1, 2, 2, 256, 256, pd, dtype)
    params = concretize(wl, H100, Schedule.fixed(variant="fa_128x128"))
    assert params.block == (128, 128)
    assert params.valid is inside, params.why_invalid
    assert concretize(wl, V5E, Schedule.fixed(variant="fa_128x128")).valid
    assert not fa_ops.supports_block_shape(0, 16, 16, dtype, 1 << 20)


def test_smem_bytes_is_nondecreasing_in_each_block_dim():
    for dtype in ("float32", "bfloat16"):
        for bq, bkv, pd in [(16, 16, 16), (64, 32, 64), (128, 128, 80),
                            (112, 256, 240)]:
            base = fa_ops.smem_bytes(bq, bkv, pd, dtype)
            assert fa_ops.smem_bytes(bq + 16, bkv, pd, dtype) >= base
            assert fa_ops.smem_bytes(bq, bkv + 16, pd, dtype) >= base
            assert fa_ops.smem_bytes(bq, bkv, pd + 16, dtype) >= base


@pytest.mark.parametrize("name", ["tpu_v5e", "cpu_interpret"])
@pytest.mark.parametrize("dims,causal", SPACE_CASES[:4])
def test_feasibility_matches_reference(name, dims, causal):
    ref, port = _pair(dims, causal)
    theirs = ref_static.feasibility(ref, ref_hw.get(name))
    ours = static_analysis.feasibility(port, hw.get(name))
    assert theirs is not None and ours is not None
    assert (ours.exhaustive, ours.total_traces, ours.valid_traces,
            ours.vmem_floor) == (theirs.exhaustive, theirs.total_traces,
                                 theirs.valid_traces, theirs.vmem_floor)
    assert ours.feasible == theirs.feasible and ours.seen == theirs.seen
    assert [str(d) for d in ours.diagnostics] == \
        [str(d) for d in theirs.diagnostics]


@pytest.mark.parametrize("dims,causal,dtype", [
    ((1, 9, 3, 64, 64, 64), True, "float32"),
    ((1, 2, 2, 256, 256, 128), False, "float32"),   # the widest rungs refused
    ((1, 2, 2, 256, 256, 128), False, "bfloat16"),  # every rung fits
    ((1, 2, 2, 256, 256, 256), False, "float32"),   # most rungs refused
])
def test_h100_analyzer_matches_exhaustive_enumeration(dims, causal, dtype):
    _, wl = _pair(dims, causal, dtype)
    report = static_analysis.analyze(wl, H100)
    assert report.exhaustive and report.valid_traces > 0
    prog = space_for(wl, H100)
    valid = [t["variant"] for t in prog.traces()
             if prog.validate(Schedule.fixed(**t)).valid]
    assert report.total_traces == 16 and report.valid_traces == len(valid)
    assert set(report.feasible["variant"]) == set(valid)


# ------------------------------------------------ the slice as a whole ----

def _report_rows(res):
    return [(r.workload.key(), r.count, r.trials,
             json.dumps(r.best_schedule.to_json()), r.best_latency,
             r.fixed_latency, r.warm_started) for r in res.reports]


@pytest.mark.parametrize("net,n_unique", [("bert_tiny", 4),
                                          ("mobilellm_125m", 6)])
@pytest.mark.parametrize("depth", [1, 2], ids=["serial", "interleaved-d2"])
def test_prefill_session_bit_identical_to_reference(net, n_unique, depth):
    """BERT-tiny and MobileLLM-125M int8 prefill at seq 64 tuned by both
    packages from seed 0 on ``V5E``: the same per-workload histories, best
    schedules, latencies and fixed baselines, attention included."""
    if depth == 1:
        runner, ref_runner = AnalyticRunner(V5E), RefAnalytic(ref_hw.V5E)
    else:
        runner, ref_runner = (SlowAnalytic(V5E, 0.0005),
                              RefSlowAnalytic(ref_hw.V5E, 0.0005))
    db, ref_db = TuningDatabase(), RefDatabase()
    ops, ref_ops = getattr(nets, net)("int8"), getattr(ref_nets, net)("int8")
    assert [(c, wl.key()) for c, wl in ops] == \
        [(c, wl.key()) for c, wl in ref_ops]
    ours = TuningSession(V5E, runner, database=db,
                         pipeline_depth=depth).tune_model(
        ops, total_trials=8 * n_unique, seed=0)
    theirs = RefSession(ref_hw.V5E, ref_runner, database=ref_db,
                        pipeline_depth=depth).tune_model(
        ref_ops, total_trials=8 * n_unique, seed=0)
    assert ours.interleaved is theirs.interleaved is (depth == 2)
    assert len(ours.reports) == n_unique
    assert "attention" in {r.workload.op for r in ours.reports}
    assert _report_rows(ours) == _report_rows(theirs)
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert ours.tuned_latency == theirs.tuned_latency
    assert ours.fixed_latency == theirs.fixed_latency


def test_reference_database_with_attention_is_analysed(tmp_path):
    """Records the JAX package wrote for attention are verified at load (a
    stale one is quarantined exactly as the reference does), and dispatch
    resolves the same schedule and KernelParams."""
    path = str(tmp_path / "db.json")
    ref_db = RefDatabase(path)
    ref_wl, wl = _pair((1, 9, 3, 256, 256, 64), True)
    ref_tuner.tune(ref_wl, ref_hw.V5E, RefAnalytic(ref_hw.V5E), trials=6,
                   seed=1, database=ref_db)
    ref_db.add(ref_wl, ref_hw.V5E.name,
               ref_schedule.Schedule.fixed(variant="fa_9999x9999"), 1e-12,
               "analytic")
    ref_db.save()
    ref_loaded = RefDatabase(path)
    db = TuningDatabase(path)
    assert ref_loaded.stale_quarantined == db.stale_quarantined == 1
    assert json.dumps(db.quarantined, sort_keys=True) == \
        json.dumps(ref_loaded.quarantined, sort_keys=True)
    assert db.records == ref_loaded.records
    ref_s, ref_prov = ref_dispatch.best_schedule(ref_wl, ref_hw.V5E,
                                                 database=ref_loaded)
    params, prov = kernel_params(wl, hw.V5E, database=db)
    assert prov == ref_prov == "tuned"
    assert dataclasses.asdict(params) == dataclasses.asdict(
        ref_space.concretize(ref_wl, ref_hw.V5E, ref_s))
