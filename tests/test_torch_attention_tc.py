"""The attention kernel on the tensor cores, held on the CPU.

``csrc/flash_attention.cu``'s ``fa_tc_kernel`` builds only on a machine
with a card; what surrounds it is Python that these tests reach:

- the gate and footprint (``kernels/flash_attention/ops.py``) against the
  kernel's constants: 16-grain bq, bkv and pd, bq <= 128, pd <= 256, the q
  tile and a two-stage k/v ring with rows padded by 16 bytes; ``ops.plan``,
  the Python mirror of ``fa_plan`` (warps, KV column split, register class,
  sub-tile), follows the rules stated in the source, and a split block's
  partial states fit in the ring;
- every trace of the ``H100`` attention spaces of BERT-tiny and
  MobileLLM-125M at seq 64 (N3, N4) and at their published max_seq_len,
  512 and 2048 (N8), is launchable and charged the kernel's shared memory,
  and the static analyzer's counts equal exhaustive enumeration;
- a plain-torch emulation of the kernel's arithmetic (3xTF32 on QK^T and
  PV in f32, bf16 QK^T with P split into TF32 hi and lo, the KV column
  split over warps, the sub-tiles and the combine in warp order) meets
  2e-3 against the JAX package's Pallas kernel in interpret mode on
  MobileLLM's causal GQA and BERT-tiny's MHA at seq 64, the ragged 17x33
  and no-visible-key 33x17 shapes and peaked scores; one TF32 pass on QK^T
  does not. The emulation is a test helper, on no path;
- the long-context networks have the JAX package's workloads, and an
  analytic ``V5E`` session over their attention is bit-identical to the
  JAX package's.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
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
from repro_torch.kernels.flash_attention import ops  # noqa: E402

FA_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
LIMIT = H100.vmem_capacity
H100_SMEM64K = dataclasses.replace(H100, name="h100_smem64k",
                                   vmem_capacity=64 * 1024)
TOL = 2e-3   # tests/test_kernels.py:141
NEG_INF = -1e30
Q_SHARP = 16.0   # q times this: scores of standard deviation ~4, not ~0.25

N3 = W.attention(1, 2, 2, 64, 64, 64, causal=False)     # BERT-tiny
N4 = W.attention(1, 9, 3, 64, 64, 64)                   # MobileLLM-125M
N8_BERT = W.attention(1, 2, 2, 512, 512, 64, causal=False)
N8_LLM = W.attention(1, 9, 3, 2048, 2048, 64)
NETWORK_SPACES = [N3, N4, N8_BERT, N8_LLM]


def _fa_smem(bq, bkv, pd, esize):
    """csrc/flash_attention.cu's fa_smem_bytes, written out: the q tile and
    two stages of a k and a v tile, rows of pd values plus 16 bytes."""
    return (bq + 4 * bkv) * (pd * esize + 16)


def _live_steps(iq, bq, bkv, pkv, offset, causal):
    """KV steps q block ``iq`` runs in the kernel (its ``steps``): all of
    them, or (causal) up to the last the Pallas predicate ``jk * bkv <= iq
    * bq + bq - 1 + offset`` keeps."""
    steps = pkv // bkv
    if causal:
        q_last = iq * bq + bq - 1 + offset
        steps = 0 if q_last < 0 else min(steps, q_last // bkv + 1)
    return steps


def _part_bytes(plan, bq, pd):
    """Shared memory the combine of a split block uses: wk * bq rows of pd
    + 4 floats, then m and l (none without a split)."""
    if plan.wk == 1:
        return 0
    return (plan.wk * bq * (pd + 4) + 2 * plan.wk * bq) * 4


def _blocks(wl, config=H100):
    found = {}
    for t in space_for(wl, config).traces():
        p = concretize(wl, config, Schedule.fixed(**t))
        found.setdefault(p.block, p)
    return [found[b] for b in sorted(found)]


# ------------------------------------------ the kernel's constants ----

def _constants():
    with open(FA_CU) as f:
        text = f.read()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (FA_\w+) = (\d+);", text)}


def test_python_constants_are_the_kernels():
    assert _constants() == {
        "FA_FRAG": ops.FA_FRAG, "FA_STAGES": ops.FA_STAGES,
        "FA_ROW_PAD": ops.FA_ROW_PAD, "FA_MIN_WARPS": ops.FA_MIN_WARPS,
        "FA_MAX_BQ": ops.FA_MAX_BQ, "FA_MAX_PD": ops.FA_MAX_PD,
        "FA_THREADS": 32 * ops.FA_MAX_BQ // ops.FA_FRAG}


@pytest.mark.parametrize("dtype,esize", [("float32", 4), ("bfloat16", 2)])
def test_smem_bytes_is_the_kernels_formula(dtype, esize):
    for bq, bkv, pd in itertools.product((16, 48, 128), (16, 80, 512),
                                         (16, 64, 144, 256)):
        assert ops.smem_bytes(bq, bkv, pd, dtype) == \
            _fa_smem(bq, bkv, pd, esize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [0, 1, 2], ids=["bq", "bkv", "pd"])
def test_smem_bytes_nondecreasing_in_each_dim(dim, dtype):
    grid = range(16, 273, 16)
    for block in itertools.product(grid, repeat=3):
        bigger = list(block)
        bigger[dim] += 16
        assert ops.smem_bytes(*bigger, dtype) >= ops.smem_bytes(*block, dtype)


@pytest.mark.parametrize("bq,bkv,pd,dtype,inside", [
    (128, 128, 64, "float32", True),      # 174,080 bytes
    (128, 128, 80, "float32", True),      # 215,040
    (128, 128, 96, "float32", False),     # 256,000
    (128, 128, 160, "bfloat16", True),    # 215,040
    (128, 128, 176, "bfloat16", False),   # 235,520
    (16, 16, 256, "float32", True),       # the largest head dim
    (16, 32, 256, "float32", True),       # 149,760
    (16, 64, 256, "float32", False),      # 282,880
    (128, 32, 256, "bfloat16", True),
    (16, 16, 272, "float32", False),      # beyond the register classes
    (144, 16, 64, "float32", False),      # more than 8 warps of rows
    (8, 16, 64, "float32", False), (16, 24, 64, "float32", False),
    (16, 16, 72, "float32", False), (16, 16, 8, "float32", False),
    (16, 16, 64, "int8", False), (0, 16, 16, "float32", False),
])
def test_gate_and_footprint_mirror_the_kernel(bq, bkv, pd, dtype, inside):
    assert ops.supports_block_shape(bq, bkv, pd, dtype, LIMIT) is inside


@pytest.mark.parametrize("block,pd,want", [
    # seq 64's tuned block: four warps, each 16 of the 64 columns
    ((16, 64), 64, dict(wq=1, wk=4, warps=4, cols=16, dclass=64, sub=16,
                        exact=True)),
    ((16, 128), 64, dict(wk=4, warps=4, cols=32, sub=32)),
    ((16, 16), 16, dict(wk=1, warps=1, cols=16, dclass=64, exact=False)),
    ((32, 32), 64, dict(wq=2, wk=2, warps=4, cols=16)),
    ((32, 128), 64, dict(wq=2, wk=2, warps=4, cols=64, sub=64)),
    # four row warps: no split; eight: none either
    ((64, 128), 64, dict(wq=4, wk=1, warps=4, cols=128, sub=64)),
    ((128, 16), 64, dict(wq=8, wk=1, warps=8, cols=16, sub=16)),
    # 48 and 80 columns do not halve into 16-column shares
    ((16, 48), 64, dict(wk=1, cols=48, sub=16)),
    ((16, 80), 64, dict(wk=1, sub=16)),
    ((16, 96), 64, dict(wk=2, cols=48, sub=16)),
    ((64, 96), 64, dict(wk=1, cols=96, sub=32)),
    ((16, 64), 128, dict(dclass=128, sub=16, exact=False)),
    ((64, 64), 128, dict(dclass=128, sub=64)),
    ((64, 64), 144, dict(dclass=256, sub=32)),
    ((64, 64), 256, dict(dclass=256, sub=32)),
])
def test_plan_follows_the_stated_rules(block, pd, want):
    p = ops.plan(*block, pd)
    assert {k: getattr(p, k) for k in want} == want


def test_split_state_fits_in_the_ring():
    """A split block's partial states (wk * bq rows of pd + 4 floats, m and
    l) fit in the k/v ring, which they reuse once the loop is done; every
    plan's warps are at most the launch bound, cover bq in 16-row warps and
    share the columns in multiples of 16."""
    for bq, bkv, pd in itertools.product(range(16, 129, 16),
                                         range(16, 513, 16),
                                         range(16, 257, 16)):
        p = ops.plan(bq, bkv, pd)
        assert 1 <= p.warps <= ops.FA_MAX_BQ // ops.FA_FRAG
        assert p.wq * ops.FA_FRAG == bq and p.wk * p.cols == bkv
        assert p.cols % 16 == 0 and pd <= p.dclass
        assert p.cols % p.sub == 0 and p.sub <= (32 if pd > 128 else 64)
        label = (f"fa_tc_kernel<f32,{p.dclass},{p.sub // 8},"
                 f"{'exact' if p.exact else 'any'}>")
        assert label in ops.kernel_labels()
        if p.wk > 1:
            assert p.warps <= ops.FA_MIN_WARPS and bkv >= 32
        for esize, dtype in ((4, "float32"), (2, "bfloat16")):
            ring = ops.smem_bytes(bq, bkv, pd, dtype) - bq * (pd * esize + 16)
            assert _part_bytes(p, bq, pd) <= ring


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
def test_shared_rows_are_free_of_bank_conflicts(esize):
    """Rows of pd values plus 16 bytes, pd a multiple of 16: the eight row
    addresses of an ldmatrix matrix fall in eight 16-byte bank groups, and
    (f32) lane (g, t)'s load of v at row 2t (or 2t + 1), column g hits 32
    banks in a warp; every row is a whole number of 16-byte copies."""
    for pd in range(16, 257, 16):
        row = pd * esize + ops.FA_ROW_PAD
        assert row % 16 == 0
        assert len({(r * row // 16) % 8 for r in range(8)}) == 8, pd
        if esize == 4:
            words = row // 4
            banks = {(2 * t * words + g) % 32 for t in range(4)
                     for g in range(8)}
            assert len(banks) == 32, pd


def test_live_steps_is_the_pallas_predicate():
    for bq, bkv, pkv, offset in itertools.product((16, 64), (16, 48, 128),
                                                  (128, 256), (-40, 0, 7)):
        for iq in range(4):
            want = sum(1 for jk in range(pkv // bkv)
                       if jk * bkv <= iq * bq + bq - 1 + offset)
            assert _live_steps(iq, bq, bkv, pkv, offset, True) == want
            assert _live_steps(iq, bq, bkv, pkv, offset, False) == \
                pkv // bkv


def test_kernel_labels():
    f32 = ("_ZN51_GLOBAL__N__fb7e477a_18_flash_attention_cu_3b2fb43b12fa_tc_"
           "kernelIfLi64ELi8ELb1EEEvNS_6FaArgsE")
    bf16 = ("_ZN51_GLOBAL__N__fb7e477a_18_flash_attention_cu_3b2fb43b12fa_tc_"
            "kernelI13__nv_bfloat16Li256ELi2ELb0EEEvNS_6FaArgsE")
    assert ops.kernel_label(f32) == "fa_tc_kernel<f32,64,8,exact>"
    assert ops.kernel_label(bf16) == "fa_tc_kernel<bf16,256,2,any>"
    assert len(ops.kernel_labels()) == len(set(ops.kernel_labels())) == 22
    assert ops.kernel_label("_ZN12_GLOBAL__N_116matmul_tc_kernelILi2E") \
        is None
    assert ops.HMMA.search("HMMA.16816.F32.BF16 R4, R8, R12, R4")
    assert not ops.HMMA.search("IMMA.16832.S8.S8 R4, R8, R12, R4")


# ------------------------------------------------ the design spaces ----

@pytest.mark.parametrize("wl", NETWORK_SPACES, ids=lambda w: w.key())
def test_every_network_trace_launches(wl):
    """Every trace of the H100 space concretizes to a block the kernel
    launches, charged its exact shared memory: no candidate of a tune can
    be INVALID. Seq 64 caps the ladder at 64."""
    blocks = set()
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        assert p.valid, (t, p.why_invalid)
        pd = p.padded_dims[5]
        assert ops.supports_block_shape(*p.block, pd, wl.dtype, LIMIT)
        assert p.vmem_bytes == ops.smem_bytes(*p.block, pd, wl.dtype) \
            == _fa_smem(*p.block, pd, 4) <= LIMIT
        lay = ops.plan(*p.block, pd)
        assert lay.warps * 32 <= 256 and lay.dclass == 64
        blocks.add(p.block)
    sizes = (16, 32, 64) if wl.dims[3] == 64 else (16, 32, 64, 128)
    assert blocks == set(itertools.product(sizes, sizes))


@pytest.mark.parametrize("config", [H100, H100_SMEM64K], ids=lambda c: c.name)
@pytest.mark.parametrize("wl", NETWORK_SPACES + [
    W.attention(1, 2, 2, 256, 256, 256, "bfloat16", causal=False),
    W.attention(1, 2, 2, 256, 256, 128)], ids=lambda w: w.key())
def test_analyzer_matches_exhaustive_enumeration(config, wl):
    """The static report's counts and feasible sets equal those of running
    every trace through concretize and the postprocessors (the launch gate
    among them); a 64 KB cap refuses the widest rungs."""
    report = static_analysis.analyze(wl, config)
    assert report.exhaustive and report.valid_traces > 0
    prog = space_for(wl, config)
    valid = [t["variant"] for t in prog.traces()
             if prog.validate(Schedule.fixed(**t)).valid]
    assert report.total_traces == len(list(prog.traces()))
    assert report.valid_traces == len(valid)
    assert set(report.feasible["variant"]) == set(valid)
    if config is H100_SMEM64K:
        assert len(valid) < report.total_traces


# --------------------------------------------- the kernel's arithmetic ----

def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest
    with ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


def _qk(q, k, f32, passes=3):
    """Scores over the head dim: 3xTF32 (lo*hi + hi*lo + hi*hi) for f32
    operands, or one TF32 pass with ``passes=1``; bf16 operands' products
    are exact in f32."""
    if not f32:
        return q @ k.mT
    (qh, ql), (kh, kl) = _split(q), _split(k)
    if passes == 1:
        return qh @ kh.mT
    return ql @ kh.mT + qh @ kl.mT + qh @ kh.mT


def _pv(p, v, f32):
    """P (split into TF32 hi and lo) times v: 3xTF32 for f32 v, two TF32
    products for bf16 v (exact in TF32)."""
    ph, pl = _split(p)
    if f32:
        vh, vl = _split(v)
        return pl @ vh + ph @ vl + ph @ vh
    return pl @ v + ph @ v


def _emulate(q, k, v, params, passes=3):
    """The kernel's arithmetic on padded operands q (BH, pq, pd), k, v
    (BH / group, pkv, pd): per q block, each warp column share kq keeps its
    own online state over its columns in sub-tiles (``ops.plan``), every
    live KV block computed in full; the shares combine in kq order. Returns
    f32 (BH, pq, pd)."""
    bh, pq, pd = q.shape
    pkv = k.shape[1]
    _b, hq, hkv = params.padded_dims[:3]
    q_len, kv_len, d_real = params.dims[3:6]
    causal = params.order == "qk_causal"
    f32 = q.dtype == torch.float32
    bq, bkv = params.block
    lay = ops.plan(bq, bkv, pd)
    scale = torch.tensor(1.0 / np.sqrt(d_real), dtype=torch.float32)
    offset = kv_len - q_len
    heads = torch.arange(bh) // (hq // hkv)
    kf, vf = k.float()[heads], v.float()[heads]
    out = torch.empty(bh, pq, pd)
    for iq in range(pq // bq):
        qb = q[:, iq * bq:(iq + 1) * bq].float()
        rows = iq * bq + offset + torch.arange(bq)[:, None]
        steps = _live_steps(iq, bq, bkv, pkv, offset, causal)
        states = []
        for kq in range(lay.wk):
            m = torch.full((bh, bq, 1), NEG_INF)
            l = torch.zeros(bh, bq, 1)
            acc = torch.zeros(bh, bq, pd)
            for jk in range(steps):
                end = (kq + 1) * lay.cols
                for c0 in range(kq * lay.cols, end, lay.sub):
                    c1 = min(c0 + lay.sub, end)
                    cols = jk * bkv + torch.arange(c0, c1)[None, :]
                    kb = kf[:, jk * bkv + c0:jk * bkv + c1]
                    vb = vf[:, jk * bkv + c0:jk * bkv + c1]
                    s = _qk(qb, kb, f32, passes) * scale
                    mask = cols < kv_len
                    if causal:
                        mask = mask & (cols <= rows)
                    s = torch.where(mask, s, NEG_INF)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = alpha * l + p.sum(-1, keepdim=True)
                    acc = acc * alpha + _pv(p, vb, f32)
                    m = m_new
            states.append((m, l, acc))
        top = states[0][0]
        for m, _, _ in states[1:]:
            top = torch.maximum(top, m)
        l_sum = torch.zeros(bh, bq, 1)
        o = torch.zeros(bh, bq, pd)
        for m, l, acc in states:
            w = torch.exp(m - top)
            l_sum = l_sum + w * l
            o = o + w * acc
        out[:, iq * bq:(iq + 1) * bq] = o / torch.where(l_sum == 0, 1.0,
                                                         l_sum)
    return out


_PALLAS = {}


def _pallas(wl, params):
    """The Pallas kernel in interpret mode for ``params``, built (and so
    jitted) once per workload and block: the plain and peaked cases differ
    only in their inputs and share its compile."""
    key = (wl.key(), params.signature())
    if key not in _PALLAS:
        _PALLAS[key] = ref_kernels.build(
            wl, ref_space.KernelParams(**dataclasses.asdict(params)),
            interpret=True, cache=False)
    return _PALLAS[key]


def _against_pallas(wl, block, seed, q_scale=1.0, passes=3):
    """The emulation and the Pallas kernel in interpret mode on the same
    inputs (q scaled by ``q_scale``) and KernelParams: both (B, Hq, Lq, D)
    as float64, the emulation before its cast to the workload dtype."""
    params = next(p for p in _blocks(wl) if p.block == block)
    q, k, v = wl.example_inputs(seed)
    inputs = (q * np.float32(q_scale), k, v)
    want = np.asarray(_pallas(wl, params)(*inputs)).astype(np.float64)
    b, hq, _, lq, _, d = wl.dims
    got = _emulate(*ops.pad_operands(params, *inputs, device="cpu"), params,
                   passes)
    got = got[:, :lq, :d].reshape(b, hq, lq, d).double().numpy()
    assert got.shape == want.shape
    return got, want


EMULATION_CASES = [
    # (dims, causal, dtype, block): split (wk 4, 2) and unsplit blocks
    ((1, 9, 3, 64, 64, 64), True, "float32", (16, 64)),   # MobileLLM GQA
    ((1, 9, 3, 64, 64, 64), True, "float32", (64, 32)),
    ((1, 9, 3, 64, 64, 64), True, "bfloat16", (32, 64)),
    ((1, 2, 2, 64, 64, 64), False, "float32", (16, 64)),  # BERT-tiny MHA
    ((1, 2, 2, 64, 64, 64), False, "float32", (64, 64)),
    ((1, 2, 2, 64, 64, 64), False, "bfloat16", (16, 32)),
    ((1, 2, 1, 17, 33, 8), True, "float32", (16, 16)),    # ragged
    ((1, 2, 1, 17, 33, 8), True, "float32", (32, 48)),
    ((1, 2, 1, 33, 17, 8), True, "float32", (16, 16)),    # no visible key
    ((1, 2, 1, 33, 17, 8), True, "float32", (48, 32)),
    ((1, 2, 1, 33, 17, 8), True, "bfloat16", (16, 32)),
]


@pytest.mark.parametrize("q_scale", [1.0, Q_SHARP], ids=["plain", "peaked"])
@pytest.mark.parametrize("dims,causal,dtype,block", EMULATION_CASES,
                         ids=str)
def test_emulation_meets_tolerance_against_pallas(dims, causal, dtype,
                                                  block, q_scale):
    wl = W.attention(*dims, dtype, causal=causal)
    got, want = _against_pallas(wl, block, 1, q_scale)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_emulated_no_key_rows_follow_the_kernel():
    """attention(1, 2, 1, 33, 17, 8) causal at (32, 32): q rows 0-15 see no
    key, but their q block's one KV block is live (q rows 16-31 see keys).
    Two warps of 16 columns each keep m = NEG_INF on those rows and combine
    with weight 1 each: the rows average all 32 v rows of the block, the
    15 padded zeros included, as the sequential loop does. A (16, 32) block
    has no live block for rows 0-15: output 0."""
    wl = W.attention(1, 2, 1, 33, 17, 8)
    blocks = {p.block: p for p in _blocks(wl)}
    params = blocks[(32, 32)]
    assert ops.plan(32, 32, 16).wk == 2
    q, k, v = wl.example_inputs(0)
    qp, kp, vp = ops.pad_operands(params, q, k, v, device="cpu")
    got = _emulate(qp, kp, vp, params)
    mean = vp[:, :32].sum(1, keepdim=True) / 32
    assert torch.allclose(got[:, :16], mean.expand(-1, 16, -1), atol=1e-6)
    assert _live_steps(0, 16, 32, 32, -16, True) == 0
    got = _emulate(*ops.pad_operands(blocks[(16, 32)], q, k, v,
                                     device="cpu"), blocks[(16, 32)])
    assert not got[:, :16].any()


def test_one_tf32_pass_misses_on_peaked_scores():
    """3xTF32 is needed on QK^T: with one TF32 pass the emulation leaves
    2e-3 on MobileLLM's peaked scores, where 3xTF32 holds it."""
    wl = W.attention(1, 9, 3, 64, 64, 64)
    got, want = _against_pallas(wl, (16, 64), 1, Q_SHARP, passes=1)
    assert not np.allclose(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------ the long-context networks ----

def _attention(ops_list):
    return [(c, wl) for c, wl in ops_list if wl.op == "attention"]


def test_long_context_networks_have_the_reference_workloads():
    for ours, theirs in ((nets.mobilellm_125m("int8", seq=2048),
                          ref_nets.mobilellm_125m("int8", seq=2048)),
                         (nets.bert_tiny("int8", seq=512),
                          ref_nets.bert_tiny("int8", seq=512))):
        assert [(c, wl.key()) for c, wl in ours] == \
            [(c, wl.key()) for c, wl in theirs]
    llm = _attention(nets.mobilellm_125m("int8", seq=2048))
    bert = _attention(nets.bert_tiny("int8", seq=512))
    assert [(c, wl.dims, "causal" in wl.tags, wl.dtype) for c, wl in llm] == \
        [(30, N8_LLM.dims, True, "float32")]
    assert [(c, wl.dims, "causal" in wl.tags) for c, wl in bert] == \
        [(1, N8_BERT.dims, False), (1, N8_BERT.dims, False)]
    assert {wl.key() for _, wl in llm} == {N8_LLM.key()}
    assert {wl.key() for _, wl in bert} == {N8_BERT.key()}


def _report_rows(res):
    return [(r.workload.key(), r.count, r.trials,
             json.dumps(r.best_schedule.to_json()), r.best_latency,
             r.fixed_latency, r.warm_started) for r in res.reports]


@pytest.mark.parametrize("depth", [1, 2], ids=["serial", "interleaved-d2"])
def test_long_context_attention_session_bit_identical_to_reference(depth):
    """The attention workloads of MobileLLM-125M at 2048 and BERT-tiny at
    512 tuned by both packages from seed 0 on ``V5E``: the same histories,
    best schedules, latencies and fixed baselines."""
    if depth == 1:
        runner, ref_runner = AnalyticRunner(V5E), RefAnalytic(ref_hw.V5E)
    else:
        runner, ref_runner = (SlowAnalytic(V5E, 0.0005),
                              RefSlowAnalytic(ref_hw.V5E, 0.0005))
    ours_ops = (_attention(nets.mobilellm_125m("int8", seq=2048))
                + _attention(nets.bert_tiny("int8", seq=512)))
    ref_ops = (_attention(ref_nets.mobilellm_125m("int8", seq=2048))
               + _attention(ref_nets.bert_tiny("int8", seq=512)))
    db, ref_db = TuningDatabase(), RefDatabase()
    ours = TuningSession(V5E, runner, database=db,
                         pipeline_depth=depth).tune_model(
        ours_ops, total_trials=16, seed=0)
    theirs = RefSession(ref_hw.V5E, ref_runner, database=ref_db,
                        pipeline_depth=depth).tune_model(
        ref_ops, total_trials=16, seed=0)
    assert ours.interleaved is theirs.interleaved is (depth == 2)
    assert len(ours.reports) == 2
    assert _report_rows(ours) == _report_rows(theirs)
    assert json.dumps(db.records) == json.dumps(ref_db.records)
    assert ours.tuned_latency == theirs.tuned_latency
