"""The bf16 tensor-core matmul slice on the CPU: its launch gate and
shared-memory footprint, the H100 design space they shape, and the
MobileLLM-125M bf16 prefill network against the JAX package.

- The bf16 gate (``kernels/matmul/ops.py``) mirrors ``csrc/matmul.cu``:
  block dims multiples of the 16x16 mma fragment, ``bm * bn <= 16384``, two
  cp.async stages of rows padded by 8 values within shared memory. Every
  H100 bf16 trace that ``concretize`` marks valid passes it and is charged
  exactly its footprint; the footprint is nondecreasing in each block dim
  (the static analyzer's floor relies on it), and the analyzer's counts
  equal exhaustive enumeration.
- The int8 gate and footprint (``csrc/tile.cuh``) are unchanged; the f32
  ones follow the 3xTF32 tensor-core kernel.
- ``nets.mobilellm_125m("bfloat16")`` has the JAX package's workloads, and
  an analytic ``V5E`` session over it is bit-identical to the JAX
  package's, serial and interleaved at depth 2.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses
import itertools
import json

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from benchmarks import nets as ref_nets  # noqa: E402
from repro.core import AnalyticRunner as RefAnalytic  # noqa: E402
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import TuningSession as RefSession  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402

from _test_runners import SlowAnalytic as RefSlowAnalytic  # noqa: E402
from _torch_test_runners import SlowAnalytic  # noqa: E402

from repro_torch import nets  # noqa: E402
from repro_torch.core import (H100, V5E, AnalyticRunner, Schedule,  # noqa: E402
                              TuningDatabase, TuningSession, concretize,
                              space_for)
from repro_torch.core import intrinsics  # noqa: E402
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402

LIMIT = H100.vmem_capacity
# W3, the bf16 LM head of MobileLLM-125M's prefill, a ragged shape, and a
# shape whose space offers the top rung.
BF16_CASES = [W.matmul(64, 1536, 576, "bfloat16"),
              W.matmul(64, 32000, 576, "bfloat16"),
              W.matmul(100, 60, 36, "bfloat16"),
              W.matmul(512, 1024, 768, "bfloat16")]
# The H100 with less shared memory: the ladder drops the rungs whose two
# stages no longer fit.
H100_SMEM32K = dataclasses.replace(H100, name="h100_smem32k",
                                   vmem_capacity=32 * 1024)


def _tc_smem(bm, bn, bk):
    """csrc/matmul.cu's tc_smem_bytes, written out."""
    return 2 * (bm * (bk + 8) + bk * (bn + 8)) * 2


@pytest.mark.parametrize("wl", BF16_CASES[:3], ids=lambda w: w.key())
def test_h100_bf16_space_offers_only_launchable_blocks(wl):
    """Every trace of the H100 bf16 space concretizes to a block the
    tensor-core kernel launches, charged its exact shared memory: no
    candidate of a tune can be INVALID."""
    report = static_analysis.analyze(wl, H100)
    assert report.exhaustive and report.valid_traces == report.total_traces
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        assert p.valid, p.why_invalid
        assert matmul_ops.supports_block_shape(*p.block, "bfloat16", LIMIT)
        assert all(b % 16 == 0 for b in p.block)
        assert p.vmem_bytes == matmul_ops.smem_bytes(*p.block, "bfloat16") \
            == _tc_smem(*p.block)


@pytest.mark.parametrize("block,inside", [
    ((16, 16, 16), True), ((16, 48, 16), True), ((80, 112, 16), True),
    ((128, 128, 128), True), ((16, 1024, 16), True),
    ((8, 16, 16), False), ((16, 24, 16), False), ((16, 16, 40), False),
    ((144, 128, 16), False),                     # bm * bn > 16384
    ((16, 16, 1440), True), ((16, 16, 1456), False),   # two stages > 227 KB
])
def test_bf16_gate_mirrors_the_tensor_core_kernel(block, inside):
    assert matmul_ops.supports_block_shape(*block, "bfloat16",
                                           LIMIT) is inside
    assert matmul_ops.smem_bytes(*block, "bfloat16") == _tc_smem(*block)


@pytest.mark.parametrize("dim", [0, 1, 2], ids=["bm", "bn", "bk"])
def test_bf16_smem_bytes_nondecreasing_in_each_dim(dim):
    grid = range(16, 257, 16)
    for block in itertools.product(grid, repeat=3):
        bigger = list(block)
        bigger[dim] += 16
        assert matmul_ops.smem_bytes(*bigger, "bfloat16") >= \
            matmul_ops.smem_bytes(*block, "bfloat16")


@pytest.mark.parametrize("config", [H100, H100_SMEM32K], ids=lambda c: c.name)
@pytest.mark.parametrize("wl", BF16_CASES, ids=lambda w: w.key())
def test_h100_bf16_analyzer_matches_exhaustive_enumeration(config, wl):
    """The static report's counts and feasible sets equal those of running
    every trace through concretize and the postprocessors (the launch gate
    among them)."""
    report = static_analysis.analyze(wl, config)
    assert report.exhaustive and report.valid_traces > 0
    prog = space_for(wl, config)
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


def test_bf16_ladder_tops_at_128_and_follows_shared_memory():
    rungs = intrinsics.all_variants("matmul", H100, "bfloat16")
    assert [v.block for v in rungs] == [(128,) * 3, (64,) * 3, (32,) * 3,
                                        (16,) * 3, (16, 16, 16)]
    # at 32 KB the 64^3 rung's two stages (36,864 bytes) no longer fit
    small = intrinsics.all_variants("matmul", H100_SMEM32K, "bfloat16")
    assert [v.block[0] for v in small] == [32, 16, 16]
    for v in rungs:
        assert matmul_ops.supports_block_shape(*v.block, "bfloat16", LIMIT)


@pytest.mark.parametrize("dtype,block,smem,inside", [
    ("float32", (64, 64, 96), 3 * (64 * 100 + 96 * 72) * 4, True),
    ("float32", (128, 128, 128), 3 * (128 * 132 + 128 * 136) * 4,
     False),                                                    # the ring
    ("float32", (16, 16, 16), 3 * (16 * 20 + 16 * 24) * 4, True),
    ("float32", (4, 4, 16), 3 * (4 * 20 + 16 * 12) * 4, False),  # 16 grain
    ("float32", (144, 128, 16), 144 * 128 * 4, False),          # outputs
    ("float32", (16, 16, 2048), 3 * (16 * 2052 + 2048 * 24) * 4,
     False),                                                    # smem
    ("int8", (64, 64, 64), 64 * 68 + 64 * 64, True),
    ("int8", (16, 32, 32), 16 * 36 + 32 * 32, True),
    ("int8", (16, 16, 2048), 16 * 2052 + 2048 * 16, True),
    ("int8", (4, 4, 6), 4 * 10 + 6 * 4, False),                 # dp4a depth
])
def test_f32_and_int8_gates_and_footprints_unchanged(dtype, block, smem,
                                                     inside):
    """The int8 kernel (csrc/tile.cuh) keeps its limits: the x tile padded
    by one 32-bit word a row plus the w tile, 4x4 micro-tiles, at most 1024
    threads, depth a multiple of 4. The f32 rows follow the 3xTF32
    tensor-core kernel that replaced the CUDA-core one
    (tests/test_torch_matmul_f32_tc.py): 16-grain blocks, at most 16384
    outputs, three ring stages of x rows padded by 4 floats and w rows by
    8, or the partial tile of a cluster, within the shared memory."""
    assert matmul_ops.smem_bytes(*block, dtype) == smem
    assert matmul_ops.supports_block_shape(*block, dtype, LIMIT) is inside


def test_mobilellm_bf16_prefill_has_the_reference_workloads():
    ops, ref_ops = nets.mobilellm_125m("bfloat16"), \
        ref_nets.mobilellm_125m("bfloat16")
    assert [(c, wl.key()) for c, wl in ops] == \
        [(c, wl.key()) for c, wl in ref_ops]
    mm = [(c, wl) for c, wl in ops if wl.op == "matmul"]
    assert sum(c for c, _ in mm) == 211
    assert len({wl.key() for _, wl in mm}) == 5
    assert all(wl.dtype == "bfloat16" for _, wl in mm)
    assert (1, W.matmul(64, 32000, 576, "bfloat16")) in [
        (c, wl) for c, wl in mm]


def _report_rows(res):
    return [(r.workload.key(), r.count, r.trials,
             json.dumps(r.best_schedule.to_json()), r.best_latency,
             r.fixed_latency, r.warm_started) for r in res.reports]


@pytest.mark.parametrize("depth", [1, 2], ids=["serial", "interleaved-d2"])
def test_mobilellm_bf16_prefill_session_bit_identical_to_reference(depth):
    """MobileLLM-125M bf16 prefill at seq 64 tuned by both packages from
    seed 0 on ``V5E``: the same per-workload histories, best schedules,
    latencies and fixed baselines, the five bf16 matmuls and the f32
    attention."""
    if depth == 1:
        runner, ref_runner = AnalyticRunner(V5E), RefAnalytic(ref_hw.V5E)
    else:
        runner, ref_runner = (SlowAnalytic(V5E, 0.0005),
                              RefSlowAnalytic(ref_hw.V5E, 0.0005))
    db, ref_db = TuningDatabase(), RefDatabase()
    ops = nets.mobilellm_125m("bfloat16")
    ref_ops = ref_nets.mobilellm_125m("bfloat16")
    ours = TuningSession(V5E, runner, database=db,
                         pipeline_depth=depth).tune_model(
        ops, total_trials=8 * 6, seed=0)
    theirs = RefSession(ref_hw.V5E, ref_runner, database=ref_db,
                        pipeline_depth=depth).tune_model(
        ref_ops, total_trials=8 * 6, seed=0)
    assert ours.interleaved is theirs.interleaved is (depth == 2)
    assert len(ours.reports) == 6
    assert {r.workload.op for r in ours.reports} == {"matmul", "attention"}
    assert _report_rows(ours) == _report_rows(theirs)
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert ours.tuned_latency == theirs.tuned_latency
    assert ours.fixed_latency == theirs.fixed_latency
