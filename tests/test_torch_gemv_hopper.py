"""The Hopper gemv kernels' launch rules, held on the CPU.

``csrc/gemv.cu`` builds only on a machine with a card; what surrounds it is
Python that these tests reach:

- every trace of the ``H100`` design space of MobileLLM-125M's batch-1
  decode step (its five gemv workloads, bf16, and their f32 twins) passes
  the launch gate, is charged the kernel's own shared memory and fits it:
  ``concretize`` finds no INVALID candidate;
- ``ops.smem_bytes`` is nondecreasing in each block dimension, and
  ``space.gemv_block_bytes`` is it on the H100 and the TPU's formula on the
  TPU configs;
- ``ops.plan``, the Python mirror of the launcher's layout (vector width,
  threads, k steps per wave, rows per thread, cluster size), follows the
  rules and constants stated in ``gemv.cu``, and the load index walk it
  implies reads every row of w exactly once per output column, each in its
  own k step;
- the SASS helpers that ``chip_smoke.py`` and the card tests use.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import os
import re

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import H100, V5E, Schedule, concretize, space_for
from repro_torch.core import space
from repro_torch.core import workload as W
from repro_torch.kernels.gemv import ops
from repro_torch.runtime.serve_loop import decode_ops

GEMV_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc", "gemv.cu")


def _decode_workloads():
    """N1's five unique gemv workloads (bf16) and their f32 twins."""
    seen, out = set(), []
    for _count, wl in decode_ops(get_config("mobilellm_125m"), 1):
        if wl.key() not in seen:
            seen.add(wl.key())
            out += [wl, W.gemv(*wl.dims, "float32")]
    return out


DECODE = _decode_workloads()


def _blocks(wl):
    """Every (bn, bk, accumulate) the H100 space offers for ``wl``, with
    its KernelParams."""
    out = {}
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        out[(*p.block, p.accumulate)] = p
    return out


def test_decode_workloads_are_the_five_projections():
    dims = sorted({wl.dims for wl in DECODE})
    assert dims == [(576, 576), (576, 1536), (960, 576), (1536, 576),
                    (32000, 576)]
    assert len(DECODE) == 10


@pytest.mark.parametrize("wl", DECODE, ids=lambda w: w.key())
def test_every_decode_trace_launches(wl):
    lane = H100.lane_align(wl.dtype)
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        assert p.valid, (t, p.why_invalid)
        assert ops.supports_block_shape(*p.block, lane), (t, p.block)
        assert p.vmem_bytes == ops.smem_bytes(*p.block, wl.dtype)
        assert p.vmem_bytes <= H100.vmem_budget


def test_decode_spaces_offer_the_blocks_the_kernel_is_held_to():
    """The bn and bk values the card tests and chip_smoke.py cover."""
    bns, bks = set(), {576: set(), 1536: set()}
    for wl in DECODE:
        for bn, bk, _acc in _blocks(wl):
            bns.add(bn)
            bks[wl.dims[1]].add(bk)
    assert bns == {1, 16, 32, 48, 64, 80, 96, 128}
    assert bks[576] == {16, 32, 48, 64, 96, 128, 144, 192, 256, 288, 512}
    assert bks[1536] == {16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                         1024}


def test_down_projection_keeps_the_blocks_the_tpu_formula_refused():
    """bn 128, bk 1024: 264,960 bytes by the TPU's VMEM formula, more than
    the H100's 232,448; the kernel asks for 16 KB."""
    wl = W.gemv(576, 1536, "bfloat16")
    p = concretize(wl, H100, Schedule.fixed(variant="vl_1024", bn=128,
                                            bk=1024, accumulate=True))
    assert p.valid and p.padded_dims == (640, 2048)
    assert p.vmem_bytes == 16384
    assert space.gemv_block_bytes(wl, V5E, 128, 1024) == 264960 \
        > H100.vmem_budget


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smem_bytes_nondecreasing_in_each_dim(dtype):
    bns = [1] + list(range(16, ops.MAX_BN + 1, 16))
    bks = list(range(16, 2049, 16))
    for bk in bks:
        col = [ops.smem_bytes(bn, bk, dtype) for bn in bns]
        assert col == sorted(col)
    for bn in bns:
        row = [ops.smem_bytes(bn, bk, dtype) for bk in bks]
        assert row == sorted(row)
    assert ops.smem_bytes(1, 16, dtype) == 2 * ops.THREADS * 4
    assert ops.smem_bytes(16, 16, dtype) == \
        {"float32": 8192, "bfloat16": 16384}[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_block_bytes_per_config(dtype):
    wl = W.gemv(960, 576, dtype)
    ib = ob = 4 if dtype == "float32" else 2   # a gemv's out_dtype is its own
    for bn, bk in ((1, 16), (16, 96), (128, 512)):
        assert space.gemv_block_bytes(wl, H100, bn, bk) == \
            ops.smem_bytes(bn, bk, dtype)
        assert space.gemv_block_bytes(wl, V5E, bn, bk) == \
            bk * ib + bk * bn * ib + bn * ob + bn * 4


def test_h100_lane_implies_the_kernels_vector_rule():
    """The gate keeps the reference's lane rule; on the H100 every lane
    multiple is a multiple of the kernel's vector width, so the gate and
    the launcher agree without a dtype."""
    for dtype in ("float32", "bfloat16"):
        lane = H100.lane_align(dtype)
        assert lane % ops.vector_width(16, dtype) == 0


# ------------------------------------------------ the launcher's rules ----

def _constants():
    with open(GEMV_CU) as f:
        text = f.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (GEMV_\w+) = (\d+);", text)}


def test_python_constants_are_the_kernels():
    c = _constants()
    assert c == {"GEMV_THREADS": ops.THREADS,
                 "GEMV_ROWS_IN_FLIGHT": ops.ROWS_IN_FLIGHT,
                 "GEMV_MAX_CLUSTER": ops.MAX_CLUSTER,
                 "GEMV_FILL_CTAS": ops.FILL_CTAS,
                 "GEMV_MAX_BN": ops.MAX_BN}


@pytest.mark.parametrize("case,want", [
    # N1's down projection at (16, 256): 36 column blocks and 12 rows a
    # thread, so _gemv_kernel splits K over 2 blocks (6 rows, one batch);
    # the noacc form computes 4 steps a wave
    ((576, 1536, 16, 256, "bfloat16", True),
     dict(ct=2, rt=128, s=16, g=1, rg=128, span=768, steps=1, nbatch=1,
          cluster=2)),
    ((576, 1536, 16, 256, "bfloat16", False),
     dict(g=4, rg=32, span=256, steps=6, waves=2, nbatch=1, cluster=1)),
    # the LM head: 1000 or 2000 blocks, no cluster
    ((32000, 576, 32, 16, "bfloat16", True),
     dict(ct=4, rt=64, s=8, span=576, nbatch=2, cluster=1)),
    ((32000, 576, 16, 48, "bfloat16", False),
     dict(g=12, rg=10, waves=1, nbatch=1, cluster=1)),
    # f32: 4 columns a thread
    ((1536, 576, 16, 96, "float32", True),
     dict(ct=4, rt=64, cluster=2, span=288)),
    # one column block: K is split until a thread has at most R rows
    ((16, 1024, 16, 16, "bfloat16", True), dict(cluster=1, nbatch=1)),
    ((16, 4096, 16, 16, "bfloat16", True),
     dict(cluster=4, span=1024, nbatch=1)),
    ((16, 8192, 16, 16, "float32", True), dict(cluster=8, nbatch=2)),
    # 131 column blocks with 2 batches a thread split; 132 do not
    ((2096, 2304, 16, 64, "bfloat16", True), dict(cluster=2, nbatch=2)),
    ((2112, 2304, 16, 64, "bfloat16", True), dict(cluster=1, nbatch=3)),
    # the J = 1 row kernel: one element a thread, 256 thread rows
    ((1, 64, 1, 16, "float32", True),
     dict(ct=1, rt=256, s=32, cluster=1, nbatch=1)),
    # the widest block: one thread row (f32) or two (bf16)
    ((2048, 64, 1024, 16, "float32", False),
     dict(ct=256, rt=1, s=1, g=1, waves=4, nbatch=2)),
    ((2048, 64, 1024, 16, "bfloat16", True), dict(ct=128, rt=2, s=1)),
])
def test_plan_follows_the_stated_rules(case, want):
    p = ops.plan(*case)
    got = {k: getattr(p, k) for k in want}
    assert got == want


def _rows_read(pn, pk, bn, bk, dtype, accumulate):
    """Rows of w each thread row reads, by (cluster rank, step), walking
    the kernel's load index (``load`` in gemv.cu) for every batch."""
    p = ops.plan(pn, pk, bn, bk, dtype, accumulate)
    R = ops.ROWS_IN_FLIGHT
    ty = np.arange(-(-ops.THREADS // p.ct))
    g, rr = ty // p.rg, ty % p.rg
    active = g < p.g
    reads = {}
    for rank in range(p.cluster):
        for it in range(p.waves * p.nbatch):
            step = (it // p.nbatch) * p.g + g
            b = it % p.nbatch
            for j in range(R):
                off = rr + (b * R + j) * p.rg
                ok = active & (step < p.steps) & (off < p.span)
                rows = rank * p.span + step * p.span + off
                for s_, r_ in zip(step[ok], rows[ok]):
                    reads.setdefault((rank, int(s_)), []).append(int(r_))
    return p, reads


@pytest.mark.parametrize("wl", DECODE, ids=lambda w: w.key())
def test_every_row_is_read_once_in_its_step(wl):
    """For every block of the space, both entries: the rows the threads
    read cover [0, pk) exactly once, each within its own k step (noacc) or
    within its block's share of K (a cluster), and the shared buffers hold
    the partials."""
    for (bn, bk, acc), params in _blocks(wl).items():
        pn, pk = params.padded_dims
        p, reads = _rows_read(pn, pk, bn, bk, wl.dtype, acc)
        v = ops.vector_width(bn, wl.dtype)
        assert p.ct * v == bn and p.rt >= 1 and p.g * p.rg <= p.rt
        assert p.rt * bn <= ops.THREADS * v          # one reduction buffer
        assert bn <= ops.THREADS * v                 # the cluster's partial
        assert (p.cluster == 1) if not acc else (pk % p.cluster == 0)
        assert p.cluster <= ops.MAX_CLUSTER
        every = sorted(r for rows in reads.values() for r in rows)
        assert every == list(range(pk)), (bn, bk, acc)
        for (rank, step), rows in reads.items():
            lo = rank * p.span + step * p.span
            assert lo <= min(rows) and max(rows) < lo + p.span


# ------------------------------------------------------ SASS helpers ----

def test_kernel_labels_and_128_bit_loads():
    mangled = ("_ZN12_GLOBAL__N_111gemv_kernelI13__nv_bfloat16Li8ELb0EEEvPKT_"
               "S4_Pfii4Plan")
    assert ops.kernel_label(mangled) == "gemv_kernel<bfloat16,8,noacc>"
    assert ops.kernel_label("_ZN12_GLOBAL__N_111gemv_kernelIfLi1ELb1EEEv") \
        == "gemv_kernel<float32,1,acc>"
    assert ops.kernel_label("_Z16matmul_tc_kernel") is None
    for line in ("LDG.E.128 R4, desc[UR4][R2.64]",
                 "LDG.E.NA.128.CONSTANT R8, desc[UR6][R4.64]",
                 "@P0 LDG.E.EF.128 R12, [R6.64]"):
        assert ops.LDG_128.search(line), line
    for line in ("LDG.E.64 R4, [R2.64]", "LDG.E.U16.CONSTANT R3, [R2.64]",
                 "LDS.128 R4, [R2]", "STG.E.128 [R2.64], R4"):
        assert not ops.LDG_128.search(line), line
