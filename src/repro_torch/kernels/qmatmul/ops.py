"""Public wrapper of the quantized matmul kernel, plus its block-shape gate,
its shared-memory footprint and the Python mirror of the launcher's layout
rules (``csrc/qmatmul.cu``: ``make_plan``).

The kernel takes the operands at their real size and masks the tail tile
itself, so ``build`` pads nothing: one launch per call."""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch import tracing
from repro_torch.core.space import KernelParams

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


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one block (``qmm_smem_bytes``): the ring of
    x (bm, bk) and w (bk, bn) tiles, or the int32 partial tile a cluster
    reduces, whichever is larger. Nondecreasing in each block dim (the
    static analyzer's floor relies on it)."""
    ring = STAGES * (bm * (bk + ROW_PAD) + bk * (bn + ROW_PAD))
    return max(ring, bm * bn * 4)


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
    computes."""
    wm: int        # fragments per warp, down the rows
    wn: int        # fragments per warp, across the columns
    warps: int
    tiles_m: int
    tiles_n: int
    steps: int     # k steps of bk
    cluster: int   # blocks that split one tile's k steps
    vx: int        # copy width of x's rows
    vw: int        # copy width of w's rows


def plan(m: int, n: int, k: int, bm: int, bn: int, bk: int,
         x_address: int = 0, w_address: int = 0,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The kernel's layout for real ``(m, n, k)`` at block ``(bm, bn, bk)``:
    the rules of ``csrc/qmatmul.cu``'s ``make_plan``, step for step
    (``max_cluster`` as ``qmatmul_launch_capped`` takes it)."""
    fm, fn = bm // FRAG_M, bn // FRAG_N
    wm = 2 if fm % 2 == 0 and (fm // 2) * fn >= MIN_WARPS else 1
    wn = 2 if fn % 2 == 0 and (fm // wm) * (fn // 2) >= MIN_WARPS else 1
    tiles_m, tiles_n, steps = -(-m // bm), -(-n // bn), -(-k // bk)
    c = 1
    while (c < max_cluster and tiles_m * tiles_n * 2 * c <= FILL_CTAS
           and steps >= 2 * c * MIN_STEPS):
        c *= 2
    return Plan(wm=wm, wn=wn, warps=(fm // wm) * (fn // wn),
                tiles_m=tiles_m, tiles_n=tiles_n, steps=steps, cluster=c,
                vx=copy_width(k, x_address), vw=copy_width(n, w_address))


def k_steps(steps: int, cluster: int, rank: int) -> range:
    """The k steps block ``rank`` of a cluster takes (a contiguous share)."""
    return range(rank * steps // cluster, (rank + 1) * steps // cluster)


_MANGLED = re.compile(r"qmm_kernelILi(\d+)ELi(\d+)E")
# An integer tensor-core instruction in SASS (IMMA.16832.S8.S8, ...).
IMMA = re.compile(r"\bIMMA\b")


def kernel_label(mangled: str) -> str | None:
    """``qmm_kernel<WM,WN>`` for the mangled name of one of
    ``csrc/qmatmul.cu``'s kernels, else None."""
    m = _MANGLED.search(mangled)
    return None if m is None else f"qmm_kernel<{m[1]},{m[2]}>"


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
