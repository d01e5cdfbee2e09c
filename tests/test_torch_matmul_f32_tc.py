"""The f32 matmul kernels on the tensor cores (3xTF32), held on the CPU.

``csrc/matmul.cu``'s ``matmul_3xtf32_kernel`` builds only on a machine with
a card; what surrounds it is Python that these tests reach:

- the f32 gate and footprint (``kernels/matmul/ops.py``) against the
  kernel's constants: 16-grain blocks, at most 16384 outputs, a three-stage
  ring of x rows padded by 4 floats and w rows by 8, or the partial tile a
  cluster reduces; ``ops.plan``, the Python mirror of ``f32_plan``, follows
  the rules stated in ``matmul.cu``;
- every trace of the ``H100`` spaces of W3 in f32, MobileNetV2 f32 (N6)
  and DCGAN f32 (N7) is launchable and charged the kernel's shared memory,
  ``smem_bytes`` is nondecreasing in each dim, and the static analyzer's
  counts equal exhaustive enumeration;
- a plain-torch emulation of the kernel's 3xTF32 arithmetic (each value
  split into TF32 hi and lo parts, rounded to nearest with ties away from
  zero as ``cvt.rna`` rounds) meets rtol 1e-4 / atol 1e-3 against the JAX
  package's ``matmul_pallas`` in interpret mode at W3 f32 and the N6 and N7
  shapes; the emulation is a test helper, on no path;
- ``nets.mobilenetv2("float32")`` and ``nets.dcgan()`` have the JAX
  package's workloads, and an analytic ``V5E`` DCGAN f32 session is
  bit-identical to the JAX package's.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses
import itertools
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from benchmarks import nets as ref_nets  # noqa: E402
from repro import kernels as ref_kernels  # noqa: E402
from repro.core import AnalyticRunner as RefAnalytic  # noqa: E402
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import TuningSession as RefSession  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import space as ref_space  # noqa: E402

from _test_runners import SlowAnalytic as RefSlowAnalytic  # noqa: E402
from _torch_test_runners import SlowAnalytic  # noqa: E402

from repro_torch import nets  # noqa: E402
from repro_torch.core import (H100, V5E, AnalyticRunner, Schedule,  # noqa: E402
                              TuningDatabase, TuningSession, concretize,
                              space_for)
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402

MATMUL_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc", "matmul.cu")
LIMIT = H100.vmem_capacity
H100_SMEM32K = dataclasses.replace(H100, name="h100_smem32k",
                                   vmem_capacity=32 * 1024)


def _unique_matmuls(ops_list):
    seen, out = set(), []
    for _count, wl in ops_list:
        if wl.op == "matmul" and wl.key() not in seen:
            seen.add(wl.key())
            out.append(wl)
    return out


W3_F32 = W.matmul(64, 1536, 576, "float32")
N6 = _unique_matmuls(nets.mobilenetv2("float32"))
N7 = _unique_matmuls(nets.dcgan())
F32_SPACES = [W3_F32] + N6 + N7


def _f32_smem(bm, bn, bk):
    """csrc/matmul.cu's f32_smem_bytes, written out: three stages of x rows
    padded by 4 floats and w rows padded by 8, or the cluster's partial
    tile."""
    return max(3 * (bm * (bk + 4) + bk * (bn + 8)) * 4, bm * bn * 4)


def _blocks(wl, config=H100):
    return sorted({concretize(wl, config, Schedule.fixed(**t)).block
                   for t in space_for(wl, config).traces()})


# ------------------------------------------ the kernel's constants ----

def _constants():
    with open(MATMUL_CU) as f:
        text = f.read()
    found = dict(re.findall(r"constexpr int (F32_\w+|FRAG) = (\d+);", text))
    return {name: int(v) for name, v in found.items()}


def test_python_constants_are_the_kernels():
    assert _constants() == {
        "FRAG": ops.MMA_FRAGMENT,
        "F32_STAGES": ops.F32_STAGES, "F32_X_PAD": ops.F32_X_PAD,
        "F32_W_PAD": ops.F32_W_PAD, "F32_MIN_WARPS": ops.F32_MIN_WARPS,
        "F32_MAX_WIDE_WARPS": ops.F32_MAX_WIDE_WARPS,
        "F32_MAX_CLUSTER": ops.F32_MAX_CLUSTER,
        "F32_FILL_CTAS": ops.F32_FILL_CTAS,
        "F32_MIN_STEPS": ops.F32_MIN_STEPS}


def test_w_row_stride_puts_a_warps_b_loads_in_32_banks():
    """Lane (g, t) loads w[k0 + t, n0 + g]: with the padded stride the 32
    words of a warp fall in 32 different banks for every 16-grain bn; and
    every padded row is a whole number of 16-byte copies."""
    for bn in range(16, 1025, 16):
        stride = bn + ops.F32_W_PAD
        banks = {(t * stride + g) % 32 for t in range(4) for g in range(8)}
        assert len(banks) == 32, bn
        assert stride * 4 % 16 == 0
    for bk in range(16, 1025, 16):   # x rows: 8 ldmatrix rows, 8 bank groups
        stride_bytes = (bk + ops.F32_X_PAD) * 4
        groups = {(r * stride_bytes // 16) % 8 for r in range(8)}
        assert len(groups) == 8, bk


@pytest.mark.parametrize("block,inside", [
    ((16, 16, 16), True), ((16, 48, 16), True), ((80, 112, 16), True),
    ((64, 64, 64), True), ((128, 128, 64), True), ((16, 1024, 16), True),
    ((16, 16, 480), True), ((16, 16, 496), False),   # the ring > 227 KB
    ((128, 128, 128), False),                        # the ring > 227 KB
    ((8, 16, 16), False), ((16, 24, 16), False), ((16, 16, 40), False),
    ((144, 128, 16), False),                         # bm * bn > 16384
])
def test_f32_gate_and_footprint_mirror_the_kernel(block, inside):
    assert ops.supports_block_shape(*block, "float32", LIMIT) is inside
    assert ops.smem_bytes(*block, "float32") == _f32_smem(*block)


def test_partial_tile_sets_the_footprint_of_shallow_blocks():
    """At bk 16 the ring of a 128 x 128 block (56,832 bytes) is smaller
    than the cluster's partial tile (65,536)."""
    assert 3 * (128 * 20 + 16 * 136) * 4 == 56832
    assert ops.smem_bytes(128, 128, 16, "float32") == 128 * 128 * 4


@pytest.mark.parametrize("case,want", [
    # W3 at the fixed library's block: 96 tiles, no cluster; 16x16 warp
    # tiles keep four warps where the bf16 rule would give two
    ((64, 1536, 576, 16, 64, 64, True),
     dict(wmf=1, wnf=1, rep=1, warps=4, tiles=96, steps=9, cluster=1)),
    # W3 at 64 x 64: 24 tiles split K over 4 blocks (96 on 132 SMs)
    ((64, 1536, 576, 64, 64, 64, True),
     dict(wmf=2, wnf=2, warps=4, tiles=24, cluster=4)),
    ((64, 1536, 576, 64, 64, 64, False), dict(cluster=1)),
    # DCGAN's 64x256x2048: 4 tiles, 32 k steps, the largest cluster
    ((64, 256, 2048, 64, 64, 64, True), dict(tiles=4, steps=32, cluster=8)),
    # each block keeps two k steps: 8 steps split over 4 at most, 4 over 2
    ((64, 64, 512, 64, 64, 64, True), dict(steps=8, cluster=4)),
    ((32, 32, 64, 16, 16, 16, True), dict(wmf=1, wnf=1, warps=1, steps=4,
                                          cluster=2)),
    # odd fragment grids: 1x2 and 2x1 warp tiles while four warps remain
    ((64, 48, 16, 64, 48, 16, True), dict(wmf=2, wnf=1, warps=6)),
    ((48, 64, 16, 48, 64, 16, True), dict(wmf=1, wnf=2, warps=6)),
    # 5 x 7 fragments: two 16x16 tiles a warp
    ((80, 112, 16, 80, 112, 16, True), dict(wmf=1, wnf=1, rep=2, warps=18)),
    # 8 x 7: a 2x1 layout would need 28 warps; 16x16 tiles, two a warp
    ((128, 112, 16, 128, 112, 16, True),
     dict(wmf=1, wnf=1, rep=2, warps=28)),
    ((128, 128, 16, 128, 128, 16, True), dict(wmf=2, wnf=2, warps=16)),
])
def test_plan_follows_the_stated_rules(case, want):
    p = ops.plan(*case)
    assert {k: getattr(p, k) for k in want} == want


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
def test_cluster_cap_and_rank_shares(cap):
    """``max_cluster`` caps the split; the ranks' shares of the k steps are
    contiguous and cover every step once, and rank r's n8 groups r, r + C,
    ... cover every group of a warp tile once."""
    p = ops.plan(64, 64, 2048, 64, 64, 32, True, cap)
    assert p.cluster == cap
    steps = [s for r in range(p.cluster)
             for s in ops.k_steps(p.steps, p.cluster, r)]
    assert steps == list(range(p.steps))
    groups = p.wmf * p.wnf * 2
    assert sorted(g for r in range(p.cluster)
                  for g in range(r, groups, p.cluster)) == list(range(groups))


# ------------------------------------------------ the design spaces ----

@pytest.mark.parametrize("wl", F32_SPACES, ids=lambda w: w.key())
def test_every_f32_trace_launches(wl):
    """Every trace of the H100 space concretizes to a block the kernel
    launches, charged its exact shared memory, with a launchable layout:
    no candidate of a tune can be INVALID."""
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        assert p.valid, (t, p.why_invalid)
        assert ops.supports_block_shape(*p.block, "float32", LIMIT)
        assert all(b % 16 == 0 for b in p.block)
        assert p.vmem_bytes == ops.smem_bytes(*p.block, "float32") \
            == _f32_smem(*p.block) <= LIMIT
        for acc in (True, False):
            lay = ops.plan(*p.padded_dims, *p.block, acc)
            bound = 512 if lay.wmf * lay.wnf > 1 else 1024
            assert 1 <= lay.warps * 32 <= bound
            assert lay.rep * lay.warps * lay.wmf * lay.wnf >= \
                (p.block[0] // 16) * (p.block[1] // 16)
            assert lay.tiles * lay.cluster <= max(lay.tiles,
                                                  ops.F32_FILL_CTAS)


def test_f32_spaces_offer_the_blocks_the_card_checks():
    """The H100 f32 ladder tops at 64 (128^3 needs 411,648 bytes of ring);
    W3 keeps its 48 blocks, DCGAN's ragged 16x512x100 and 4096x3x256 one."""
    assert len(_blocks(W3_F32)) == 48
    assert max(_blocks(W3_F32)) == (64, 64, 64)
    assert _blocks(W.matmul(16, 512, 100, "float32")) == [(16, 16, 16)]
    assert _blocks(W.matmul(4096, 3, 256, "float32")) == [(16, 16, 16)]
    assert len(_blocks(W.matmul(12544, 32, 27, "float32"))) == 8


@pytest.mark.parametrize("dim", [0, 1, 2], ids=["bm", "bn", "bk"])
def test_f32_smem_bytes_nondecreasing_in_each_dim(dim):
    grid = range(16, 257, 16)
    for block in itertools.product(grid, repeat=3):
        bigger = list(block)
        bigger[dim] += 16
        assert ops.smem_bytes(*bigger, "float32") >= \
            ops.smem_bytes(*block, "float32")


@pytest.mark.parametrize("config", [H100, H100_SMEM32K], ids=lambda c: c.name)
@pytest.mark.parametrize("wl", [W3_F32, W.matmul(12544, 32, 27, "float32"),
                                W.matmul(49, 1280, 320, "float32"),
                                W.matmul(256, 128, 1024, "float32"),
                                W.matmul(4096, 3, 256, "float32")],
                         ids=lambda w: w.key())
def test_h100_f32_analyzer_matches_exhaustive_enumeration(config, wl):
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


# --------------------------------------------- the 3xTF32 arithmetic ----

def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (add half of the dropped 13 bits' unit to the
    magnitude, then clear them)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul_3xtf32(x: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """The kernel's arithmetic on padded operands: per k step, lo*hi, hi*lo
    and hi*hi of TF32 parts (each product exact in f32) summed from zero,
    then added to the f32 accumulator."""
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], bk):
        xb, wb = x[:, k0:k0 + bk], w[k0:k0 + bk]
        xh, wh = _tf32_rna(xb), _tf32_rna(wb)
        xl, wl = _tf32_rna(xb - xh), _tf32_rna(wb - wh)
        d = xl @ wh
        d += xh @ wl
        d += xh @ wh
        acc += d
    return acc


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10           # a TF32 value: unchanged
    half = 2.0 ** -11                # half a TF32 unit at 1.0: a tie
    v = torch.tensor([one, 1.0 + half, -(1.0 + half), 1.0 + half / 2,
                      1.0 + 3 * half / 2], dtype=torch.float32)
    got = _tf32_rna(v).tolist()
    assert got == [one, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                   1.0 + 2.0 ** -10]
    r = _tf32_rna(torch.randn(4096))
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)


@pytest.mark.parametrize("wl", [W3_F32, W.matmul(12544, 32, 27, "float32"),
                                W.matmul(3136, 24, 96, "float32"),
                                W.matmul(49, 1280, 320, "float32"),
                                W.matmul(16, 512, 100, "float32"),
                                W.matmul(64, 256, 2048, "float32"),
                                W.matmul(4096, 3, 256, "float32")],
                         ids=lambda w: w.key())
def test_3xtf32_emulation_meets_tolerance_against_pallas(wl):
    """At the space's largest block (the fewest interpret grid steps), the
    emulated 3xTF32 product equals the JAX package's Pallas kernel in
    interpret mode within rtol 1e-4 / atol 1e-3; one TF32 pass would not
    (checked at W3's k = 576 and beyond)."""
    block = max(_blocks(wl), key=lambda b: (b[0] * b[1] * b[2], b))
    params = next(p for p in (concretize(wl, H100, Schedule.fixed(**t))
                              for t in space_for(wl, H100).traces())
                  if p.block == block and p.accumulate)
    x, w = wl.example_inputs(1)
    want = np.asarray(ref_kernels.build(
        wl, ref_space.KernelParams(**dataclasses.asdict(params)),
        interpret=True, cache=False)(x, w))
    (m, n, k), (pm, pn, pk) = wl.dims, params.padded_dims
    xp = torch.zeros(pm, pk)
    wp = torch.zeros(pk, pn)
    xp[:m, :k] = torch.from_numpy(x)
    wp[:k, :n] = torch.from_numpy(w)
    got = _matmul_3xtf32(xp, wp, block[2])[:m, :n].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    if k >= 576:
        one_pass = (_tf32_rna(xp) @ _tf32_rna(wp))[:m, :n].numpy()
        assert not np.allclose(one_pass, want, rtol=1e-4, atol=1e-3)


# ----------------------------------------------- the f32 networks ----

def test_f32_networks_have_the_reference_workloads():
    for ours, theirs in ((nets.mobilenetv2("float32"),
                          ref_nets.mobilenetv2("float32")),
                         (nets.dcgan(), ref_nets.dcgan())):
        assert [(c, wl.key()) for c, wl in ours] == \
            [(c, wl.key()) for c, wl in theirs]
    mnv2 = nets.mobilenetv2("float32")
    assert {wl.dtype for _, wl in mnv2} == {"float32"}
    assert sum(c for c, wl in mnv2 if wl.op == "matmul") == 36
    assert sum(c for c, wl in mnv2 if wl.op == "vmacc") == 153
    assert [wl.dims for _, wl in mnv2 if wl.op == "gemv"] == [(1000, 1280)]
    assert len(N6) == 16 and len(N7) == 5
    assert [wl.dims for wl in N7] == [(16, 512, 100), (64, 256, 2048),
                                      (256, 128, 1024), (1024, 64, 512),
                                      (4096, 3, 256)]


def _report_rows(res):
    return [(r.workload.key(), r.count, r.trials,
             json.dumps(r.best_schedule.to_json()), r.best_latency,
             r.fixed_latency, r.warm_started) for r in res.reports]


@pytest.mark.parametrize("depth", [1, 2], ids=["serial", "interleaved-d2"])
def test_dcgan_f32_session_bit_identical_to_reference(depth):
    """DCGAN f32 tuned by both packages from seed 0 on ``V5E``: the same
    per-workload histories, best schedules, latencies and fixed
    baselines."""
    if depth == 1:
        runner, ref_runner = AnalyticRunner(V5E), RefAnalytic(ref_hw.V5E)
    else:
        runner, ref_runner = (SlowAnalytic(V5E, 0.0005),
                              RefSlowAnalytic(ref_hw.V5E, 0.0005))
    db, ref_db = TuningDatabase(), RefDatabase()
    ours = TuningSession(V5E, runner, database=db,
                         pipeline_depth=depth).tune_model(
        nets.dcgan(), total_trials=8 * 5, seed=0)
    theirs = RefSession(ref_hw.V5E, ref_runner, database=ref_db,
                        pipeline_depth=depth).tune_model(
        ref_nets.dcgan(), total_trials=8 * 5, seed=0)
    assert ours.interleaved is theirs.interleaved is (depth == 2)
    assert len(ours.reports) == 5
    assert _report_rows(ours) == _report_rows(theirs)
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert ours.tuned_latency == theirs.tuned_latency
    assert ours.fixed_latency == theirs.fixed_latency


# ------------------------------------------------------ SASS helpers ----

def test_kernel_labels_and_tf32_hmma():
    mangled = ("_ZN41_GLOBAL__N__42bcca10_9_matmul_cu_3b2fb43b20matmul_"
               "3xtf32_kernelILi1ELi1ELi2ELb0EEEvNS_7F32ArgsE")
    assert ops.kernel_label(mangled) == "matmul_3xtf32_kernel<1,1,2,noacc>"
    assert ops.bf16_kernel_label(mangled) is None
    bf16 = "_ZN12_GLOBAL__N_116matmul_tc_kernelILi2ELi2ELi1ELb1EEEvPK"
    assert ops.bf16_kernel_label(bf16) == "matmul_tc_kernel<2,2,1,acc>"
    assert ops.kernel_label(bf16) is None
    for line in ("HMMA.1688.F32.TF32 R4, R8, R12, R4",
                 "HMMA.1684.F32.TF32 R20, R24, R26, R20"):
        assert ops.HMMA_TF32.search(line), line
    for line in ("HMMA.16816.F32.BF16 R4, R8, R12, R4",
                 "IMMA.16832.S8.S8 R4, R8, R12, R4"):
        assert not ops.HMMA_TF32.search(line), line
