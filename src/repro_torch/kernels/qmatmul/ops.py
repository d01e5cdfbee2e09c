"""Public wrapper of the quantized matmul kernel, plus its block-shape gate,
its shared-memory footprints and the Python mirror of the launcher's layout
rules (``csrc/qmatmul.cu``: ``make_plan``, ``make_wg_plan``).

The kernel takes the operands at their real size and masks the tail tile
itself, so ``build`` pads nothing: one launch per call."""

from __future__ import annotations

import dataclasses
import functools
import re

import torch

from repro_torch import tracing
from repro_torch.core.space import KernelParams
from repro_torch.kernels import Family
from repro_torch.kernels.matmul.ops import int_mm, k_steps  # noqa: F401
from repro_torch.kernels.qmatmul.plain import requantize
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

DEFAULT_SCALE = 0.01

# csrc/qmatmul.cu: a QMM_STAGES-deep cp.async ring whose shared rows are
# padded by ROW_PAD bytes; warp fragments of FRAG_M rows x FRAG_N columns x
# FRAG_K depth (one m16 x four n8 x k32 of mma.sync); at most MAX_OUTPUTS
# outputs a block (32 warps); K split over a cluster of at most MAX_CLUSTER
# blocks while the grid stays within FILL_CTAS (the H100's 132 SMs) and
# each block keeps MIN_STEPS k steps; a block keeps MIN_WARPS warps where
# its tile allows.
STAGES = 3
ROW_PAD = 16
MAX_OUTPUTS = 16384
MAX_CLUSTER = 8
FILL_CTAS = 132
MIN_STEPS = 2
MIN_WARPS = 4
FRAG_M, FRAG_N, FRAG_K = 16, 32, 32
# The wgmma loop: blocks of WG_THREADS threads, two consumer warpgroups
# taking alternate units of WG_UNIT rows (two halves of WG_ROWS) and a
# producer warpgroup, bn up to WG_MAX_N (both halves' sums in a thread's
# registers); a ring of WG_MIN_STAGES to WG_MAX_STAGES slots, as many as fit
# beside the resident w and even (each warpgroup owns every other slot);
# panels aligned to ALIGN bytes; SMEM_LIMIT the bytes a block may opt into.
WG_ROWS = 64
WG_UNIT = 128
WG_MAX_N = 128
WG_MIN_STAGES = 4
WG_MAX_STAGES = 32
WG_THREADS = 384
ALIGN = 1024
SMEM_LIMIT = 232448


@dataclasses.dataclass(frozen=True)
class WgPlan:
    """The wgmma loop's layout ``make_wg_plan`` computes (sizes in bytes)."""
    bulk: bool      # x by 1D bulk copies of whole units (K % 16 != 0)
    panel: int      # P: bytes of k a ring slot holds (32, 64 or 128)
    kp: int         # K padded to whole panels
    units_m: int    # units of WG_UNIT rows
    stages: int     # ring slots
    blocks: int     # persistent blocks
    w_vec: bool     # w read 4 bytes at a time
    x_slot: int     # one ring slot
    smem: int       # dynamic shared memory of one block


def wgmma_fixed_bytes(bn: int) -> int:
    """The wgmma loop's shared memory besides its ring, w and re-laid rows
    (``wg_fixed``): the alignment slack, the bias slice, the barriers."""
    return ALIGN + 4 * bn + 2 * WG_MAX_STAGES * 8


def wgmma_plan(m: int, n: int, k: int, bm: int, bn: int,
               x_address: int = 0, w_address: int = 0) -> WgPlan | None:
    """The wgmma loop's layout for real ``(m, n, k)`` at a block of ``bm``
    rows and ``bn`` columns, or None where the call keeps the mma.sync loop:
    the rules of ``csrc/qmatmul.cu``'s ``make_wg_plan``, step for step. It
    takes blocks of one or two warpgroups of rows, ``bn`` up to 128, x on
    the 16-byte grain, at least ``FILL_CTAS`` units of ``WG_UNIT`` rows in at
    most ``FILL_CTAS`` columns of tiles, and ``WG_MIN_STAGES`` ring slots
    beside the block's (kp, bn) slice of w. Its staging (units of 128 rows,
    panels of 32, 64 or 128 bytes of k) follows K, not the block's bm or
    bk; the ring takes what is left of ``SMEM_LIMIT``. Where K is not a
    multiple of 16 (``bulk``) a slot is a whole unit, re-laid by its
    consumer warpgroup into panels of K padded to 32."""
    units_m, tiles_n = -(-m // WG_UNIT), -(-n // bn)
    if (bm % WG_ROWS or bm > WG_UNIT or bn > WG_MAX_N
            or units_m * tiles_n < FILL_CTAS or tiles_n > FILL_CTAS
            or x_address % 16):
        return None
    bulk = k % 16 != 0
    if bulk:   # re-laid whole: K to 32 bytes, in the widest panels that fit
        kp = -(-k // 32) * 32
        panel = 128 if kp % 128 == 0 else 64 if kp % 64 == 0 else 32
    else:      # a ring slot a panel
        panel = 32 if k <= 32 else 64 if k <= 64 else 128
        kp = -(-k // panel) * panel
    x_slot = (-(-(WG_UNIT * k + 32) // ALIGN) * ALIGN if bulk
              else WG_UNIT * panel)
    fixed = (wgmma_fixed_bytes(bn) + kp * bn
             + (2 * WG_UNIT * kp if bulk else 0))
    stages = (SMEM_LIMIT - fixed) // x_slot
    if stages < WG_MIN_STAGES:
        return None
    stages = min(stages, WG_MAX_STAGES) & ~1
    return WgPlan(bulk=bulk, panel=panel, kp=kp, units_m=units_m,
                  stages=stages, blocks=FILL_CTAS // tiles_n * tiles_n,
                  w_vec=n % 4 == 0 and w_address % 4 == 0, x_slot=x_slot,
                  smem=fixed + stages * x_slot)


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one block of the mma.sync loop
    (``qmm_smem_bytes``): the ring of x (bm, bk) and w (bk, bn) tiles, or
    the int32 partial tile a cluster reduces, whichever is larger. What the
    gate holds a block to (every block it accepts can take this loop: x
    off the 16-byte grain keeps it). Nondecreasing in each block dim."""
    ring = STAGES * (bm * (bk + ROW_PAD) + bk * (bn + ROW_PAD))
    return max(ring, bm * bn * 4)


def smem_floor(bm: int, bn: int, bk: int) -> int:
    """At most ``plan(...).smem`` of every block at least ``(bm, bn, bk)`` in
    each dim, at any shape: the least of the mma.sync loop's footprint
    (nondecreasing) and the least the wgmma loop ever asks (its fixed bytes
    at bn 32, a (32, 32) slice of w, WG_MIN_STAGES slots of WG_UNIT rows x
    32 bytes). The static analyzer's floor."""
    least_wgmma = (wgmma_fixed_bytes(FRAG_N) + FRAG_K * FRAG_N
                   + WG_MIN_STAGES * WG_UNIT * FRAG_K)
    return min(smem_bytes(bm, bn, bk), least_wgmma)


def supports_block_shape(bm: int, bn: int, bk: int, smem_limit: int) -> bool:
    """Can the qmatmul kernel launch a (bm, bn, bk) block?

    bm a multiple of the 16-row mma fragment, bn and bk multiples of 32 (four
    n8 mma tiles, one k32), at most 16384 outputs (32 warps of 16 x 32) and
    the block's shared memory (``smem_bytes``) within ``smem_limit``. Every
    int8 block of the H100 space is on that grain (``hardware.py``:
    ``int8_k_grain``), so the gate keeps exactly the blocks the CUDA-core
    kernel's gate kept there."""
    if bm < FRAG_M or bn < FRAG_N or bk < FRAG_K:
        return False
    if bm % FRAG_M or bn % FRAG_N or bk % FRAG_K:
        return False
    if bm * bn > MAX_OUTPUTS:
        return False
    return smem_bytes(bm, bn, bk) <= smem_limit


def copy_width(row_bytes: int, address: int) -> int:
    """Bytes of one staging copy of a row-major int8 operand whose rows are
    ``row_bytes`` long and which starts at ``address``: 16, 8 or 4 where
    both allow it (``cp.async``), else 1 (byte loads)."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and address % v == 0:
            return v
    return 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-time layout ``make_plan`` in ``csrc/qmatmul.cu``
    computes, and the loop the launch takes (``wgmma``: its layout, or None
    for the mma.sync loop, whose fields the first nine are).

    ``smem``, the footprint ``concretize`` charges, is that loop's: not
    monotone in the block (the wgmma ring fills what w leaves), so the
    static analyzer takes ``smem_floor``. The wgmma loop reads only bn of
    the block, and neither loop the order or accumulate: blocks with one
    ``launch_key`` launch one kernel on one layout."""
    wm: int        # fragments per warp, down the rows
    wn: int        # fragments per warp, across the columns
    warps: int
    tiles_m: int
    tiles_n: int
    steps: int     # k steps of bk
    cluster: int   # blocks that split one tile's k steps
    vx: int        # copy width of x's rows
    vw: int        # copy width of w's rows
    smem: int      # dynamic shared memory of one block
    launch_key: tuple  # ("wgmma", bn) or ("mma", bm, bn, bk)
    wgmma: WgPlan | None = None

    @property
    def path(self) -> str:
        return "mma" if self.wgmma is None else "wgmma"


@functools.lru_cache(maxsize=8192)
def plan(m: int, n: int, k: int, bm: int, bn: int, bk: int,
         x_address: int = 0, w_address: int = 0,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The kernel's layout for real ``(m, n, k)`` at block ``(bm, bn, bk)``:
    the rules of ``csrc/qmatmul.cu``'s ``make_plan`` and ``make_wg_plan``,
    step for step (``max_cluster`` as ``qmatmul_launch_capped`` takes it;
    it does not move the choice of loop). Memoised: the tuner asks it
    for each trace's footprint and launch key."""
    fm, fn = bm // FRAG_M, bn // FRAG_N
    wm = 2 if fm % 2 == 0 and (fm // 2) * fn >= MIN_WARPS else 1
    wn = 2 if fn % 2 == 0 and (fm // wm) * (fn // 2) >= MIN_WARPS else 1
    tiles_m, tiles_n, steps = -(-m // bm), -(-n // bn), -(-k // bk)
    c = 1
    while (c < max_cluster and tiles_m * tiles_n * 2 * c <= FILL_CTAS
           and steps >= 2 * c * MIN_STEPS):
        c *= 2
    g = wgmma_plan(m, n, k, bm, bn, x_address, w_address)
    if g is None:
        smem, launch = smem_bytes(bm, bn, bk), ("mma", bm, bn, bk)
    else:
        smem, launch = g.smem, ("wgmma", bn)
    return Plan(wm=wm, wn=wn, warps=(fm // wm) * (fn // wn),
                tiles_m=tiles_m, tiles_n=tiles_n, steps=steps, cluster=c,
                vx=copy_width(k, x_address), vw=copy_width(n, w_address),
                smem=smem, launch_key=launch, wgmma=g)


_MANGLED = re.compile(r"qmm_kernelILi(\d+)ELi(\d+)E")
_MANGLED_WGMMA = re.compile(r"5wgmma10qmm_kernelILi(\d+)EE")
# Integer tensor-core instructions in SASS: IMMA (IMMA.16832.S8.S8, mma.sync)
# and IGMMA (IGMMA.64x64x32.S8.S8, wgmma).
IMMA = re.compile(r"\bIMMA\b")
IGMMA = re.compile(r"\bIGMMA\b")


def kernel_label(mangled: str) -> str | None:
    """``qmm_kernel<WM,WN>`` (the mma.sync loop) or ``wgmma::qmm_kernel<BN>``
    (the wgmma loop) for the mangled name of one of ``csrc/qmatmul.cu``'s
    kernels, else None."""
    m = _MANGLED_WGMMA.search(mangled)
    if m is not None:
        return f"wgmma::qmm_kernel<{m[1]}>"
    m = _MANGLED.search(mangled)
    return None if m is None else f"qmm_kernel<{m[1]},{m[2]}>"


def census_fault(label: str, sass: str) -> str | None:
    """Why the SASS of the kernel ``kernel_label`` names shows it off the
    tensor cores, or None: the wgmma loop's kernels must issue IGMMA, the
    mma.sync loop's IMMA."""
    want = IGMMA if label.startswith("wgmma::") else IMMA
    if want.search(sass):
        return None
    return f"{label} has no {want.pattern[2:-2]}: not on the tensor cores"


def build(params: KernelParams, device: str = "cuda",
          scale: float = DEFAULT_SCALE):
    """``f(x, w, bias) -> requant(x @ w + bias)`` (int8) for this schedule,
    on ``device``: inputs (numpy arrays or tensors) are moved there as int8
    (bias int32) and handed to the kernel at their real size. Inputs that
    are already contiguous on the device in those dtypes are not copied."""
    from repro_torch.kernels.qmatmul.kernel import qmatmul_ragged

    def f(x, w, bias):
        with tracing.span("qmatmul.call"):
            x, w = (torch.as_tensor(t, device=device).to(torch.int8)
                    .contiguous() for t in (x, w))
            bias = torch.as_tensor(bias, device=device).to(torch.int32)
            return qmatmul_ragged(x, w, bias.contiguous(), scale,
                                  params.block)

    return f


# The family's answers to the tuner (``kernels.family``).
FAMILY = Family(
    gate=lambda wl, block, hw: supports_block_shape(*block, hw.vmem_capacity),
    footprint=lambda wl, block, hw: plan(*wl.dims, *block).smem,
    floor=lambda wl, block, hw: smem_floor(*block),
    key=lambda params: plan(*params.dims, *params.block).launch_key,
    build=build, reference=lambda wl: qmatmul_ref,
    baseline=lambda wl: lambda x, w, bias: requantize(
        int_mm(x, w), bias[None, :], DEFAULT_SCALE))
