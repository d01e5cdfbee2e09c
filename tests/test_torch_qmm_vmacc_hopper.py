"""The Hopper qmatmul and vmacc kernels' unpadded entries and launch rules,
held on the CPU.

``csrc/qmatmul.cu`` and ``csrc/vmacc.cu`` build only on a machine with a
card; what surrounds them is Python that these tests reach:

- the unpadded entries ``qmatmul_ragged`` and ``vmacc_ragged`` (what
  ``ops.build`` calls, no padding) on their plain path against the JAX
  package's Pallas kernels in interpret mode, which pad the inputs to the
  block and slice the result: qmatmul exact, vmacc 1e-5
  (tests/test_kernels.py);
- a property over ragged shapes and blocks: the unpadded entry equals the
  padded entry on zero-padded operands, sliced, and ``ops.plan`` (the
  Python mirror of each launcher's ``make_plan``) covers every k step and
  every tile exactly once;
- the mirrors' constants against the ones ``qmatmul.cu`` and ``vmacc.cu``
  state, read from the sources, and the rules at the main paths' shapes:
  which of qmatmul's two loops (mma.sync, or the warp-specialised wgmma
  loop) a call takes at the benchmark cells' 30 distinct shapes, at the
  batch-1 and prefill shapes and on each side of every limit of the rule;
- the footprints ``concretize`` charges: on ``V5E`` the JAX package's,
  value for value; on ``H100`` the shared memory of the loop the launch
  takes, with every trace of MobileNetV2 int8's and MobileLLM-125M int8
  prefill's spaces launchable; the mma.sync loop's nondecreasing in each
  block dim, the wgmma loop's bounded from below by the static analyzer's
  floor; and the launches that run one kernel, which the measuring runner
  times once.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses
import os
import re

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
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402

from repro_torch import kernels, nets  # noqa: E402
from repro_torch.core import H100, V5E, Schedule, concretize, space_for  # noqa: E402
from repro_torch.core import fixed_library_schedule  # noqa: E402
from repro_torch.core import space  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qmm_ops  # noqa: E402
from repro_torch.kernels.qmatmul.kernel import (  # noqa: E402
    qmatmul_blocked, qmatmul_ragged)
from repro_torch.kernels.qmatmul.ref import qmatmul_ref  # noqa: E402
from repro_torch.kernels.vmacc import ops as vmacc_ops  # noqa: E402
from repro_torch.kernels.vmacc.kernel import (  # noqa: E402
    vmacc_blocked, vmacc_ragged)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")
SCALE = qmm_ops.DEFAULT_SCALE


def _constants(name):
    """``constexpr int NAME = value;`` of a source in csrc/, by name."""
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _blocks(wl, hw=H100):
    return sorted({concretize(wl, hw, Schedule.fixed(**t)).block
                   for t in space_for(wl, hw).traces()})


def _pallas(wl, block, inputs):
    """The JAX package's op (pad, Pallas kernel in interpret mode, slice)
    at ``block``, as concretized on the H100 grain."""
    params = _params(wl, block)
    return np.asarray(ref_kernels.build(
        wl, ref_space.KernelParams(**dataclasses.asdict(params)),
        interpret=True, cache=False)(*inputs))


def _params(wl, block):
    if wl.op == "qmatmul":
        decisions = dict(variant="mxu_min", bm=block[0], bn=block[1],
                         bk=block[2], order="mnk", accumulate=True)
    else:
        decisions = dict(variant="vl_min", br=block[0], bc=block[1])
    params = concretize(wl, H100, Schedule.fixed(**decisions))
    assert params.block == tuple(block)
    return params


def _pad(t, rows, cols):
    return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                       0, rows - t.shape[0]))


# ------------------------------------------------- against the JAX package ----

@pytest.mark.parametrize("dims", [(49, 24, 27), (1, 40, 96), (33, 65, 17)],
                         ids=str)
def test_qmatmul_ragged_matches_pallas_interpret(dims):
    """Every block the H100 space offers, and a larger one: the unpadded
    entry (and the op ``kernels.build`` makes of it) equals the Pallas
    kernel on padded inputs, sliced, bit for bit."""
    wl = W.qmatmul(*dims)
    inputs = wl.example_inputs(3)
    x, w, bias = (torch.from_numpy(a) for a in inputs)
    for block in _blocks(wl) + [(32, 64, 64)]:
        want = _pallas(wl, block, inputs)
        got = qmatmul_ragged(x, w, bias, SCALE, block)
        assert got.dtype == torch.int8 and tuple(got.shape) == dims[:2]
        np.testing.assert_array_equal(got.numpy(), want)
        op = kernels.build(wl, _params(wl, block), device="cpu",
                           cache=False)(*inputs)
        np.testing.assert_array_equal(op.numpy(), want)


@pytest.mark.parametrize("dims,blocks", [
    ((196, 192), [(16, 16), (32, 48), (32, 128)]),
    ((49, 96), [(16, 16), (32, 64)]),
    ((33, 17), [(16, 16), (32, 32)]),
], ids=["196x192", "49x96", "33x17"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmacc_ragged_matches_pallas_interpret(dims, blocks, dtype):
    wl = W.vmacc(*dims, dtype=dtype)
    inputs = wl.example_inputs(4)
    tensors = [torch.from_numpy(a).to(torch.float32) for a in inputs]
    if dtype == "bfloat16":
        tensors = [t.bfloat16() for t in tensors]
    for block in blocks:
        assert block in _blocks(wl)
        want = _pallas(wl, block, inputs).astype(np.float64)
        got = vmacc_ragged(*tensors, block)
        assert tuple(got.shape) == dims
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        op = kernels.build(wl, _params(wl, block), device="cpu",
                           cache=False)(*inputs)
        np.testing.assert_allclose(op.double().numpy(), want, rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------- properties ----

QMM_BLOCKS = [(16, 32, 32), (32, 64, 32), (48, 32, 64), (64, 96, 96),
              (128, 128, 128), (16, 512, 32)]


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 90), n=st.integers(1, 140), k=st.integers(1, 300),
       block=st.sampled_from(QMM_BLOCKS), seed=st.integers(0, 2**16))
def test_qmatmul_ragged_equals_padded_and_plan_covers(m, n, k, block, seed):
    """The unpadded entry equals the padded entry on zero-padded operands,
    sliced, and the oracle; the plan's tiles cover the output and its
    cluster's shares cover every k step once, each share long enough."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    bias = torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32))
    bm, bn, bk = block
    pm, pn, pk = (-(-d // b) * b for d, b in zip((m, n, k), block))
    got = qmatmul_ragged(x, w, bias, SCALE, block)
    padded = qmatmul_blocked(_pad(x, pm, pk), _pad(w, pk, pn),
                             torch.nn.functional.pad(bias, (0, pn - n)),
                             SCALE, block)
    assert torch.equal(got, padded[:m, :n])
    assert torch.equal(got, qmatmul_ref(x, w, bias, SCALE))

    p = qmm_ops.plan(m, n, k, *block)
    assert (p.tiles_m * bm, p.tiles_n * bn, p.steps * bk) == (pm, pn, pk)
    shares = [list(qmm_ops.k_steps(p.steps, p.cluster, r))
              for r in range(p.cluster)]
    assert sum(shares, []) == list(range(p.steps))
    if p.cluster > 1:
        assert p.tiles_m * p.tiles_n * p.cluster <= qmm_ops.FILL_CTAS
        assert min(map(len, shares)) >= qmm_ops.MIN_STEPS
    assert p.warps * p.wm * p.wn == (bm // 16) * (bn // 32)


@settings(max_examples=25, deadline=None)
@given(r=st.integers(1, 300), c=st.integers(1, 300), br=st.integers(1, 64),
       bc=st.integers(1, 160), dtype=st.sampled_from(["float32",
                                                      "bfloat16"]),
       aligned=st.booleans(), seed=st.integers(0, 2**16))
def test_vmacc_ragged_equals_padded_and_plan_covers(r, c, br, bc, dtype,
                                                    aligned, seed):
    """The unpadded entry equals the padded entry on zero-padded arrays,
    sliced; the plan's blocks take every tile once (bands of ``per`` tiles
    down each column of tiles), and its vectors never straddle a tile's or
    the array's edge."""
    rng = np.random.default_rng(seed)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    a, b, cc = (torch.from_numpy(rng.standard_normal((r, c)).astype(
        np.float32)).to(tdtype) for _ in range(3))
    pr, pc = -(-r // br) * br, -(-c // bc) * bc
    got = vmacc_ragged(a, b, cc, (br, bc))
    padded = vmacc_blocked(*(_pad(t, pr, pc) for t in (a, b, cc)), (br, bc))
    assert torch.equal(got, padded[:r, :c])

    p = vmacc_ops.plan(r, c, br, bc, dtype, aligned)
    gr = pr // br
    assert p.tiles == gr * (pc // bc) and p.gc == pc // bc
    bands = p.blocks // p.gc
    assert bands * p.gc == p.blocks and (bands - 1) * p.per < gr <= bands \
        * p.per
    if p.v > 1:
        assert aligned and c % p.v == 0 and bc % p.v == 0
    if p.per > 1:
        assert p.tiles // p.per >= vmacc_ops.FILL_CTAS
        assert p.per * (br * bc // p.v) <= vmacc_ops.THREADS \
            * vmacc_ops.UNROLL


# --------------------------------------------- the mirrors and the source ----

def test_qmatmul_mirror_constants_match_the_source():
    c = _constants("qmatmul.cu")
    assert (c["QMM_STAGES"], c["QMM_ROW_PAD"], c["QMM_MAX_OUTPUTS"],
            c["QMM_MAX_CLUSTER"], c["QMM_FILL_CTAS"], c["QMM_MIN_STEPS"],
            c["QMM_MIN_WARPS"]) == (
        qmm_ops.STAGES, qmm_ops.ROW_PAD, qmm_ops.MAX_OUTPUTS,
        qmm_ops.MAX_CLUSTER, qmm_ops.FILL_CTAS, qmm_ops.MIN_STEPS,
        qmm_ops.MIN_WARPS)
    assert (c["FRAG_M"], c["FRAG_N"], c["FRAG_K"]) == (
        qmm_ops.FRAG_M, qmm_ops.FRAG_N, qmm_ops.FRAG_K)
    assert c["QMM_FILL_CTAS"] == H100.sm_count
    assert (c["QMM_WG_ROWS"], c["QMM_WG_UNIT"], c["QMM_WG_MAX_N"],
            c["QMM_WG_MIN_STAGES"], c["QMM_WG_MAX_STAGES"],
            c["QMM_WG_THREADS"], c["QMM_ALIGN"], c["QMM_SMEM_LIMIT"]) == (
        qmm_ops.WG_ROWS, qmm_ops.WG_UNIT, qmm_ops.WG_MAX_N,
        qmm_ops.WG_MIN_STAGES, qmm_ops.WG_MAX_STAGES, qmm_ops.WG_THREADS,
        qmm_ops.ALIGN, qmm_ops.SMEM_LIMIT)
    # two consumer warpgroups and a producer one, whose registers fit a
    # sub-partition's 16384 after setmaxnreg: two consumer warps, one
    # producer warp
    assert c["QMM_WG_UNIT"] == 2 * c["QMM_WG_ROWS"]
    assert c["QMM_WG_THREADS"] == 3 * 128
    assert (2 * c["QMM_WG_CONSUMER_REGS"] + c["QMM_WG_PRODUCER_REGS"]) * 32 \
        <= 16384
    assert c["QMM_SMEM_LIMIT"] == H100.vmem_capacity
    assert c["QMM_WG_ROWS"] == H100.mxu_dim


def test_vmacc_mirror_constants_match_the_source():
    c = _constants("vmacc.cu")
    assert (c["VMACC_THREADS"], c["VMACC_UNROLL"], c["VMACC_FILL_CTAS"]) \
        == (vmacc_ops.THREADS, vmacc_ops.UNROLL, vmacc_ops.FILL_CTAS)


@pytest.mark.parametrize("dims,block,cluster", [
    ((64, 576, 1536), (64, 64, 64), 8),    # N4: 9 tiles, 24 k steps
    ((64, 576, 576), (64, 64, 64), 4),     # 9 k steps: 2 or 3 a block
    ((64, 1536, 576), (64, 64, 64), 4),    # 24 tiles, 9 k steps
    ((1, 1000, 1280), (16, 32, 32), 4),    # N2's classifier: 32 tiles
    ((3136, 64, 576), (64, 64, 64), 2),    # W1: 49 tiles
    ((64, 32000, 576), (64, 64, 64), 1),   # W2: 500 tiles
    ((12544, 32, 27), (16, 32, 32), 1),    # one k step
])
def test_qmatmul_split_rule_at_the_main_paths_shapes(dims, block, cluster):
    """The batch-1 and prefill shapes keep the mma.sync loop and its split:
    their grids do not fill the card (W2's 500 tiles lie in 500 columns, more
    than a persistent grid holds)."""
    assert qmm_ops.plan(*dims, *block).cluster == cluster
    assert qmm_ops.plan(*dims, *block, max_cluster=1).cluster == 1
    assert qmm_ops.plan(*dims, *block).path == "mma"


@pytest.mark.parametrize("block,layout", [
    ((16, 32, 32), (1, 1, 1)), ((32, 32, 32), (1, 1, 2)),
    ((64, 64, 64), (2, 1, 4)), ((128, 128, 128), (2, 2, 8)),
    ((16, 512, 32), (1, 2, 8)), ((80, 96, 32), (1, 1, 15)),
])
def test_qmatmul_warp_layout(block, layout):
    p = qmm_ops.plan(64, 64, 64, *block)
    assert (p.wm, p.wn, p.warps) == layout
    assert p.path == "mma" and p.wgmma is None      # one tile


# The benchmark cells' distinct qmatmul shapes (ResNet18 at batch 64, 9;
# MobileNetV2 at batch 96, 21), each at its space's largest block: the loop
# it takes, and for the wgmma loop whether x comes by bulk copies (K not a
# multiple of 16).
CELL_SHAPES = [
    ((802816, 64, 147), (64, 64, 64), "wgmma", True),
    ((200704, 64, 576), (64, 64, 64), "wgmma", False),
    ((50176, 128, 576), (128, 128, 128), "wgmma", False),
    ((50176, 128, 1152), (128, 128, 128), "wgmma", False),
    ((12544, 256, 1152), (128, 128, 128), "wgmma", False),
    ((12544, 256, 2304), (128, 128, 128), "mma", None),    # w 295 KB
    ((3136, 512, 2304), (128, 128, 128), "mma", None),     # 100 units
    ((3136, 512, 4608), (128, 128, 128), "mma", None),
    ((64, 1000, 512), (64, 64, 64), "mma", None),          # the fc
    ((1204224, 32, 27), (32, 32, 32), "mma", None),        # 32-row blocks
    ((1204224, 16, 32), (32, 32, 32), "mma", None),
    ((1204224, 96, 16), (32, 32, 32), "mma", None),
    ((301056, 24, 96), (32, 32, 32), "mma", None),
    ((301056, 144, 24), (32, 32, 32), "mma", None),
    ((301056, 24, 144), (32, 32, 32), "mma", None),
    ((75264, 32, 144), (32, 32, 32), "mma", None),
    ((75264, 192, 32), (32, 32, 32), "mma", None),
    ((75264, 32, 192), (32, 32, 32), "mma", None),
    ((18816, 64, 192), (64, 64, 64), "wgmma", False),
    ((18816, 384, 64), (64, 64, 64), "wgmma", False),
    ((18816, 64, 384), (64, 64, 64), "wgmma", False),
    ((18816, 96, 384), (64, 64, 64), "wgmma", False),
    ((18816, 576, 96), (64, 64, 64), "wgmma", False),
    ((18816, 96, 576), (64, 64, 64), "wgmma", False),
    ((4704, 160, 576), (128, 128, 128), "mma", None),      # 74 units
    ((4704, 960, 160), (128, 128, 128), "wgmma", False),
    ((4704, 160, 960), (128, 128, 128), "mma", None),
    ((4704, 320, 960), (128, 128, 128), "mma", None),      # 111 units
    ((4704, 1280, 320), (128, 128, 128), "wgmma", False),
    ((96, 1000, 1280), (64, 64, 64), "mma", None),         # the classifier
]


def _largest_block(dims):
    wl = W.qmatmul(*dims)
    program = space_for(wl, H100)
    ctx = {"variant": program.candidates("variant")[0]}
    return tuple(max(program.candidates(d, ctx)) for d in ("bm", "bn", "bk"))


@pytest.mark.parametrize("dims,block,path,bulk", CELL_SHAPES,
                         ids=[str(c[0]) for c in CELL_SHAPES])
def test_qmatmul_loop_at_the_cells_shapes(dims, block, path, bulk):
    """The loop each cell shape takes at its space's largest block, and at
    every block of its space: the wgmma loop only where the block is one or
    two warpgroups of rows and the units fill the card, never for a block
    of 16 to 48 rows; the wgmma loop's persistent grid and shared memory
    within the card's."""
    assert _largest_block(dims) == block
    p = qmm_ops.plan(*dims, *block)
    assert p.path == path
    if bulk is not None:
        assert p.wgmma.bulk is bulk
    for b in _blocks(W.qmatmul(*dims)):
        q = qmm_ops.plan(*dims, *b)
        if b[0] not in (64, 128):
            assert q.path == "mma", b
        if q.path == "wgmma":
            g = q.wgmma
            assert g.units_m * q.tiles_n >= qmm_ops.FILL_CTAS >= q.tiles_n
            assert q.cluster == 1
            assert g.smem <= qmm_ops.SMEM_LIMIT
            assert g.blocks % q.tiles_n == 0
            assert g.blocks // q.tiles_n <= g.units_m
            assert g.blocks <= qmm_ops.FILL_CTAS


@pytest.mark.parametrize("dims,block,address,path", [
    ((16896, 64, 576), (64, 64, 64), 0, "wgmma"),     # 132 units
    ((16768, 64, 576), (64, 64, 64), 0, "mma"),       # 131 units
    ((16896, 64, 576), (48, 64, 64), 0, "mma"),       # 48 rows: no wgmma m
    ((16896, 64, 576), (192, 64, 64), 0, "mma"),      # three warpgroups
    ((16896, 64, 576), (128, 64, 64), 0, "wgmma"),
    ((16896, 64, 576), (64, 64, 64), 8, "mma"),       # x off the TMA grain
    ((16896, 64, 576), (64, 64, 64), 16, "wgmma"),
    ((16896, 160, 64), (64, 160, 64), 0, "mma"),      # bn past 128
    ((16896, 128, 64), (64, 128, 64), 0, "wgmma"),
    ((64, 32000, 576), (16, 32, 32), 0, "mma"),       # W2: 1000 columns
    ((256, 8512, 64), (64, 64, 64), 0, "mma"),        # 133 columns
    ((256, 8448, 64), (64, 64, 64), 0, "wgmma"),      # 132 columns
    ((16896, 64, 147), (64, 64, 64), 8, "mma"),       # bulk needs the grain
    ((50176, 128, 1280), (128, 128, 128), 0, "wgmma"),  # w 160 KB: 4 slots
    ((50176, 128, 1408), (128, 128, 128), 0, "mma"),    # w 176 KB: 3
], ids=["fill", "short", "bm48", "bm192", "bm128", "x8", "x16", "bn160",
        "bn128", "w2", "columns", "columns132", "bulk8", "w-fits",
        "w-too-wide"])
def test_qmatmul_loop_rule_at_its_limits(dims, block, address, path):
    """Each limit of the rule, on both sides."""
    assert qmm_ops.plan(*dims, *block, x_address=address).path == path


def _fixed(bn):
    return 1024 + 4 * bn + 2 * 32 * 8


@pytest.mark.parametrize("dims,block,expect", [
    # (bulk, panel, kp, stages, blocks, x slot, smem)
    ((802816, 64, 147), (64, 64, 64),
     (True, 32, 160, 8, 132, 19456,
      _fixed(64) + 160 * 64 + 2 * 128 * 160 + 8 * 19456)),
    ((200704, 64, 576), (64, 64, 64),
     (False, 128, 640, 10, 132, 16384, _fixed(64) + 640 * 64 + 10 * 16384)),
    ((200704, 64, 576), (64, 32, 32),
     (False, 128, 640, 12, 132, 16384, _fixed(32) + 640 * 32 + 12 * 16384)),
    ((50176, 128, 1152), (128, 128, 96),
     (False, 128, 1152, 4, 132, 16384,
      _fixed(128) + 1152 * 128 + 4 * 16384)),
    ((3136, 512, 4608), (64, 32, 64),
     (False, 128, 4608, 4, 128, 16384, _fixed(32) + 4608 * 32 + 4 * 16384)),
    ((20000, 800, 320), (64, 96, 96),
     (False, 128, 384, 10, 126, 16384, _fixed(96) + 384 * 96 + 10 * 16384)),
    ((18816, 384, 64), (64, 64, 64),
     (False, 64, 64, 26, 132, 8192, _fixed(64) + 64 * 64 + 26 * 8192)),
    ((1204224, 96, 16), (64, 96, 32),
     (False, 32, 32, 32, 132, 4096, _fixed(96) + 32 * 96 + 32 * 4096)),
], ids=["conv1-bulk", "conv2", "conv2-32", "conv3-bk96", "conv5-bn32",
        "bn96", "panel64", "panel32"])
def test_qmatmul_wgmma_layout(dims, block, expect):
    """The wgmma loop's panel, ring and persistent grid, whatever the block's
    bk, and its shared memory term by term (``wgmma_fixed_bytes``: alignment
    slack, bias slice, barriers; then the resident w, the re-laid rows and
    the ring's slots)."""
    g = qmm_ops.plan(*dims, *block).wgmma
    assert (g.bulk, g.panel, g.kp, g.stages, g.blocks, g.x_slot,
            g.smem) == expect


@pytest.mark.parametrize("dims", [c[0] for c in CELL_SHAPES], ids=str)
def test_qmatmul_wgmma_ring_fills_the_shared_memory(dims):
    """At every block of a cell shape's space that takes the wgmma loop, the
    ring holds an even number of slots (each consumer warpgroup owns every
    other one), as many as the card's shared memory leaves (two more would
    not fit, unless it is at its cap) and at least the minimum, and the
    layout follows the shape, not the block's bk."""
    for b in _blocks(W.qmatmul(*dims)):
        g = qmm_ops.plan(*dims, *b).wgmma
        if g is None:
            continue
        assert qmm_ops.WG_MIN_STAGES <= g.stages <= qmm_ops.WG_MAX_STAGES
        assert g.stages % 2 == 0
        assert g.smem <= qmm_ops.SMEM_LIMIT
        if g.stages < qmm_ops.WG_MAX_STAGES:
            assert g.smem + 2 * g.x_slot > qmm_ops.SMEM_LIMIT, b
        for bk in (32, 64, 96, 128):
            assert qmm_ops.plan(*dims, b[0], b[1], bk).wgmma == g


@pytest.mark.parametrize("dims", [c[0] for c in CELL_SHAPES], ids=str)
def test_qmatmul_charged_the_loop_the_launch_takes(dims):
    """At a cell shape ``concretize`` charges each block the shared memory
    of the loop its launch takes: the wgmma loop's exact bytes where the
    rule takes it (up to the card's limit, so every such block still fits),
    else the mma.sync loop's; the static analyzer's floor at any smaller
    block lies at or below it."""
    wl = W.qmatmul(*dims)
    blocks = _blocks(wl)
    for b in blocks:
        p = concretize(wl, H100, Schedule.fixed(variant="mxu_min", bm=b[0],
                                                bn=b[1], bk=b[2]))
        g = qmm_ops.plan(*dims, *b).wgmma
        want = qmm_ops.smem_bytes(*b) if g is None else g.smem
        assert space.matmul_block_bytes(wl, H100, *b) == want
        assert p.vmem_bytes == want, b
        assert want <= H100.vmem_capacity
        for small in blocks:
            if all(s <= d for s, d in zip(small, b)):
                assert kernels.family("qmatmul").floor(wl, small,
                                                       H100) <= want


@pytest.mark.parametrize("dims,block,path,bulk", CELL_SHAPES,
                         ids=[str(c[0]) for c in CELL_SHAPES])
def test_qmatmul_launch_key_names_one_kernel(dims, block, path, bulk):
    """Blocks the wgmma loop takes at one bn share a launch key, whatever
    their bm and bk; every mma.sync block keys on its own (bm, bn, bk).
    So a cell shape's space holds as many keys as distinct launches."""
    blocks = _blocks(W.qmatmul(*dims))
    keys = {qmm_ops.plan(*dims, *b).launch_key for b in blocks}
    wgmma_bn = {b[1] for b in blocks
                if qmm_ops.plan(*dims, *b).path == "wgmma"}
    mma = {b for b in blocks if qmm_ops.plan(*dims, *b).path == "mma"}
    assert keys == {("wgmma", bn) for bn in wgmma_bn} | {
        ("mma", *b) for b in mma}
    assert qmm_ops.plan(*dims, *block).launch_key[0] == path
    if path == "wgmma":
        for bm in (64, 128):
            for bk in (32, 64, 96, 128):
                assert qmm_ops.plan(*dims, bm, block[1], bk).launch_key \
                    == ("wgmma", block[1])
        assert qmm_ops.plan(*dims, 32, block[1], 32).launch_key[0] == "mma"


def test_qmatmul_launch_key_reaches_the_runner():
    """``kernels.launch_key`` gives qmatmul's key for its params, blind to
    order and accumulate, and None for the other ops."""
    wl = W.qmatmul(200704, 64, 576)
    a = concretize(wl, H100, Schedule.fixed(variant="mxu_min", bm=64, bn=64,
                                            bk=32, order="mnk",
                                            accumulate=True))
    b = concretize(wl, H100, Schedule.fixed(variant="mxu_min", bm=128,
                                            bn=64, bk=128, order="nmk",
                                            accumulate=False))
    assert a.valid and b.valid and a.signature() != b.signature()
    assert kernels.launch_key(a) == kernels.launch_key(b) == ("wgmma", 64)
    c = concretize(wl, H100, Schedule.fixed(variant="mxu_min", bm=32, bn=64,
                                            bk=64, order="nmk"))
    assert kernels.launch_key(c) == ("mma", 32, 64, 64)
    v = W.vmacc(196, 192)
    assert kernels.launch_key(concretize(
        v, H100, fixed_library_schedule(v, H100))) is None


def test_qmatmul_kernel_labels_and_census():
    """Both loops' kernels by their mangled names; the SASS census asks
    IGMMA of the wgmma loop's, IMMA of the mma.sync loop's, and refuses a
    qmatmul kernel with neither. As the profiler prints them, both names
    match the benchmark's pattern for qmm_kernel, only the wgmma loop's the
    pattern of its qmm_wgmma_share."""
    mma_name = "_ZN12_GLOBAL__N_110qmm_kernelILi2ELi1EEEvNS_4ArgsE"
    wg_name = "_ZN12_GLOBAL__N_15wgmma10qmm_kernelILi128EEEvNS0_4ArgsE"
    assert qmm_ops.kernel_label(mma_name) == "qmm_kernel<2,1>"
    assert qmm_ops.kernel_label(wg_name) == "wgmma::qmm_kernel<128>"
    assert qmm_ops.kernel_label("_ZN12_GLOBAL__N_112vmacc_kernelIfLi4EEEvv") \
        is None
    assert qmm_ops.census_fault("qmm_kernel<2,1>", "IMMA.16832.S8.S8") is None
    assert qmm_ops.census_fault("wgmma::qmm_kernel<64>",
                                "IGMMA.64x64x32.S8.S8 R24") is None
    assert qmm_ops.census_fault("wgmma::qmm_kernel<64>", "IMMA.16832.S8.S8")
    assert qmm_ops.census_fault("qmm_kernel<1,1>", "IGMMA.64x64x32.S8.S8")
    assert qmm_ops.census_fault("qmm_kernel<1,1>", "IDP.4A.S8.S8")
    printed = ["void (anonymous namespace)::qmm_kernel<2, 1>((anonymous "
               "namespace)::Args)",
               "void (anonymous namespace)::wgmma::qmm_kernel<64>((anonymous "
               "namespace)::wgmma::Args)"]
    assert all(re.search(r"\bqmm_kernel\b", name) for name in printed)
    assert [bool(re.search(r"\bwgmma::qmm_kernel\b", name))
            for name in printed] == [False, True]
    assert "IGMMA" in qmm_ops.census_fault("wgmma::qmm_kernel<64>", "IMMA")


def test_qmatmul_warps_within_launch_bounds():
    """__launch_bounds__: 1024 threads for the 1 x 1 warp layout, 512 for
    the others, at every block the gate accepts."""
    for bm in range(16, 1025, 16):
        for bn in range(32, 1025, 32):
            if not qmm_ops.supports_block_shape(bm, bn, 32, 1 << 30):
                continue
            p = qmm_ops.plan(bm, bn, 32, bm, bn, 32)
            assert p.warps * 32 <= (1024 if p.wm * p.wn == 1 else 512)


def test_copy_widths():
    assert [qmm_ops.copy_width(k, 0) for k in (576, 24, 1000, 60, 27)] == \
        [16, 8, 8, 4, 1]
    assert [qmm_ops.copy_width(576, a) for a in (1, 2, 4, 8, 16, 24)] == \
        [1, 1, 4, 8, 16, 8]


@pytest.mark.parametrize("dims,block,dtype,plan", [
    ((12544, 32), (16, 32), "float32", (4, 1, 784, 5, 157)),
    ((196, 192), (16, 128), "float32", (4, 2, 26, 1, 26)),
    ((49, 960), (16, 128), "bfloat16", (8, 8, 32, 1, 32)),
    ((33, 17), (16, 16), "float32", (1, 2, 6, 1, 6)),
])
def test_vmacc_plan_at_the_main_paths_shapes(dims, block, dtype, plan):
    p = vmacc_ops.plan(*dims, *block, dtype)
    assert (p.v, p.gc, p.tiles, p.per, p.blocks) == plan


# -------------------------------------------------------------- footprints ----

def _n2_n4():
    seen, out = set(), []
    for _count, wl in nets.mobilenetv2("int8") + nets.mobilellm_125m("int8"):
        if wl.op in ("qmatmul", "vmacc") and wl.key() not in seen:
            seen.add(wl.key())
            out.append(wl)
    return out


N2_N4 = _n2_n4()


def test_n2_n4_workloads():
    assert len(N2_N4) == 29
    assert {wl.op for wl in N2_N4} == {"qmatmul", "vmacc"}


@pytest.mark.parametrize("wl", N2_N4, ids=lambda w: w.key())
def test_v5e_footprints_are_the_references(wl):
    """On the TPU configuration every trace concretizes to the JAX
    package's KernelParams, footprint included."""
    ref_wl = (ref_W.qmatmul(*wl.dims) if wl.op == "qmatmul"
              else ref_W.vmacc(*wl.dims, dtype=wl.dtype))
    for t in space_for(wl, V5E).traces():
        ours = concretize(wl, V5E, Schedule.fixed(**t))
        theirs = ref_space.concretize(ref_wl, ref_hw.V5E,
                                      ref_schedule.Schedule.fixed(**t))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("wl", N2_N4, ids=lambda w: w.key())
def test_h100_traces_launch_and_are_charged_the_kernels_smem(wl):
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        assert p.valid, (t, p.why_invalid)
        if wl.op == "qmatmul":
            assert qmm_ops.supports_block_shape(*p.block,
                                                H100.vmem_capacity)
            assert p.vmem_bytes == qmm_ops.plan(*wl.dims, *p.block).smem
            g = qmm_ops.plan(*wl.dims, *p.block).wgmma
            assert p.vmem_bytes == (qmm_ops.smem_bytes(*p.block) if g is None
                                    else g.smem)
        else:
            assert p.vmem_bytes == space.vmacc_block_bytes(wl, H100,
                                                           *p.block) == 0


def test_footprints_nondecreasing_in_each_dim():
    dims = range(32, 513, 32)
    for bm in range(16, 257, 16):
        for bn in dims:
            col = [qmm_ops.smem_bytes(bm, bn, bk) for bk in dims]
            assert col == sorted(col)
    for bn in dims:
        for bk in dims:
            col = [qmm_ops.smem_bytes(bm, bn, bk) for bm in range(16, 257,
                                                                 16)]
            assert col == sorted(col)
    for bm in range(16, 257, 16):
        for bk in dims:
            row = [qmm_ops.smem_bytes(bm, bn, bk) for bn in dims]
            assert row == sorted(row)
            row = [qmm_ops.smem_floor(bm, bn, bk) for bn in dims]
            assert row == sorted(row)
            row = [qmm_ops.smem_floor(bm, bk, bn) for bn in dims]  # in bk
            assert row == sorted(row)
    for bn in dims:
        col = [qmm_ops.smem_floor(bm, bn, 64) for bm in range(16, 257, 16)]
        assert col == sorted(col)
    wl = W.vmacc(196, 192)
    for hw in (H100, V5E):
        grid = [[space.vmacc_block_bytes(wl, hw, br, bc)
                 for bc in range(16, 513, 16)] for br in range(16, 257, 16)]
        assert all(row == sorted(row) for row in grid)
        assert all(list(col) == sorted(col) for col in zip(*grid))
    assert space.vmacc_block_bytes(wl, V5E, 32, 128) == 4 * 32 * 128 * 4
    assert qmm_ops.smem_bytes(64, 64, 64) == 3 * (64 * 80 + 64 * 80)
    assert qmm_ops.smem_bytes(128, 128, 32) == 128 * 128 * 4
