"""Multi-granularity micro-kernel variant registry (paper §III).

The paper's central practical trick: RVV's VL is runtime-variable, but a
MetaSchedule intrinsic *definition* needs static shapes — so they register
*multiple versions* of each intrinsic, ``VL = VLMAX`` halving down to 4
(plus ``J = VLEN/32`` and a ``J = 1`` fallback), and let the tuner match each
operator against all of them.

The JAX package's Pallas block shapes are compile-time static for exactly
the same reason, so it registers a ladder of block-granularity variants per
op family, derived from the hardware config (on-chip memory and compute
geometry play VLEN's role). The port keeps the ladder as the first decision
of every design space, although its CUDA kernels take the block as runtime
arguments. ``variants_for`` filters the ladder against a concrete workload the
same way MetaSchedule's matcher does: a variant whose block exceeds the
(padded) operand extents is not applicable.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.hardware import CudaHardwareConfig, HardwareConfig
from repro_torch.core.workload import Workload, dtype_bytes


@dataclasses.dataclass(frozen=True)
class IntrinsicVariant:
    """One registered micro-kernel granularity (one "VL version")."""

    op: str
    name: str
    block: tuple[int, ...]  # op-family specific block dims (see space.py)

    def to_json(self):
        return {"op": self.op, "name": self.name, "block": list(self.block)}


def _halving_ladder(vmax: int, vmin: int) -> list[int]:
    """VLMAX, VLMAX/2, ..., down to vmin — the paper's registration rule.

    vmax is first floored to a power-of-two multiple of vmin so every rung
    stays hardware-aligned (lane/sublane multiples) under halving.
    """
    if vmax < vmin:
        return [vmin]
    v = vmin
    while v * 2 <= vmax:
        v *= 2
    out = []
    while v >= vmin:
        out.append(v)
        v //= 2
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul_variants(hw: HardwareConfig, dtype: str) -> list[IntrinsicVariant]:
    """Ladder of (bm, bn, bk) tiles.

    VLMAX analogue: the largest MXU-aligned tile whose working set
    (x-block + w-block + f32 accumulator) fits a half-VMEM budget.
    On a :class:`CudaHardwareConfig` see :func:`_cuda_matmul_variants`.
    """
    if isinstance(hw, CudaHardwareConfig):
        return _cuda_matmul_variants(hw, dtype)
    lane = hw.lane_align(dtype)
    sub = hw.sublane_align(dtype)
    budget = hw.vmem_capacity // 2
    ib = dtype_bytes(dtype)
    # Largest square-ish tile fitting the budget:  bm=bn=bk=t
    #   ib*t^2 (x) + ib*t^2 (w) + 4*t^2 (acc) <= budget
    t = int(math.sqrt(budget / (2 * ib + 4)))
    tmax = max(lane, (t // lane) * lane)
    variants = []
    for b in _halving_ladder(tmax, lane):
        variants.append(IntrinsicVariant("matmul", f"mxu_{b}", (b, b, b)))
    # J=1-style fallback for ragged/small leading dims: minimal sublane tile.
    variants.append(IntrinsicVariant("matmul", "mxu_min", (sub, lane, lane)))
    return variants


def _cuda_matmul_variants(hw: CudaHardwareConfig,
                          dtype: str) -> list[IntrinsicVariant]:
    """The matmul ladder for the port's CUDA kernels.

    The accumulator lives in registers, so only the x and w tiles count
    against shared memory, and all of it: the largest square tile t with
    ``2 * ib * t^2 <= vmem_capacity``, floored to the lane grain, halved
    down to one grain. Rungs the kernel cannot launch (its register
    accumulator bounds the output tile) are dropped, so every rung is a
    launchable block."""
    from repro_torch.kernels.matmul import ops as matmul_ops  # lazy: no cycle

    lane = hw.lane_align(dtype)
    sub = hw.sublane_align(dtype)
    t = int(math.sqrt(hw.vmem_capacity / (2 * dtype_bytes(dtype))))
    tmax = max(lane, (t // lane) * lane)
    variants = [IntrinsicVariant("matmul", f"mxu_{b}", (b, b, b))
                for b in _halving_ladder(tmax, lane)
                if matmul_ops.supports_block_shape(b, b, b, dtype,
                                                   hw.vmem_capacity)]
    variants.append(IntrinsicVariant("matmul", "mxu_min", (sub, lane, lane)))
    return variants


def gemv_variants(hw: HardwareConfig, dtype: str) -> list[IntrinsicVariant]:
    """(bn, bk) ladder — Algorithm 1's (J, VL).

    J = VLEN/32 analogue: output-block rows = one VPU tile of lanes;
    J = 1 fallback registered as well (paper registers both).
    """
    lane = hw.lane_align(dtype)
    budget = hw.vmem_capacity // 2
    ib = dtype_bytes(dtype)
    # w-block dominates: ib * bn * bk <= budget with bn = lane
    kmax = max(lane, (budget // (ib * lane) // lane) * lane)
    variants = []
    for bk in _halving_ladder(kmax, lane):
        variants.append(IntrinsicVariant("gemv", f"vl_{bk}", (lane, bk)))
    variants.append(IntrinsicVariant("gemv", "j1", (1, lane)))  # J = 1
    return variants


def vmacc_variants(hw: HardwareConfig, dtype: str) -> list[IntrinsicVariant]:
    """(brows, bcols) ladder for Algorithm 2 (elementwise multiply-acc)."""
    lane = hw.lane_align(dtype)
    sub = hw.sublane_align(dtype)
    budget = hw.vmem_capacity // 2
    ib = dtype_bytes(dtype)
    # four blocks live (a, b, c, out): 4 * ib * br * bc <= budget, bc = 8*lane
    bc = 8 * lane
    rmax = max(sub, (budget // (4 * ib * bc) // sub) * sub)
    variants = []
    for br in _halving_ladder(rmax, sub):
        variants.append(IntrinsicVariant("vmacc", f"vl_{br}x{bc}", (br, bc)))
    variants.append(IntrinsicVariant("vmacc", "vl_min", (sub, lane)))
    return variants


def attention_variants(hw: HardwareConfig, dtype: str) -> list[IntrinsicVariant]:
    """(block_q, block_kv) ladder for the flash-attention kernel."""
    lane = hw.lane_align(dtype)
    ladder = _halving_ladder(8 * lane, lane)
    variants = []
    for bq in ladder:
        for bkv in ladder:
            variants.append(
                IntrinsicVariant("attention", f"fa_{bq}x{bkv}", (bq, bkv)))
    return variants


_FAMILY = {
    "matmul": matmul_variants,
    "qmatmul": matmul_variants,  # same tiling family, int8 alignment
    "gemv": gemv_variants,
    "vmacc": vmacc_variants,
    "attention": attention_variants,
}


@functools.lru_cache(maxsize=None)
def _all_variants_cached(op: str, hw: HardwareConfig,
                         dtype: str) -> tuple[IntrinsicVariant, ...]:
    return tuple(dataclasses.replace(v, op=op) for v in _FAMILY[op](hw, dtype))


def all_variants(op: str, hw: HardwareConfig, dtype: str) -> list[IntrinsicVariant]:
    # The registry is a pure function of (op, hw, dtype) and both key types
    # are frozen dataclasses — memoized because the design-space programs'
    # candidate-set closures hit it on every trace replay (it dominated
    # sampling cost when recomputed: the ladder + dataclass copies ran
    # tens of thousands of times per tuning session).
    return list(_all_variants_cached(op, hw, dtype))


@functools.lru_cache(maxsize=None)
def _variants_for_cached(workload: Workload,
                         hw: HardwareConfig) -> tuple[IntrinsicVariant, ...]:
    cands = all_variants(workload.op, hw, workload.dtype)
    dims = workload.dims
    # the TPU configs' matcher pads to a fixed (8, 128) grain, whatever the
    # config; a CUDA config pads to its own grain
    sub, lane = 8, 128
    if isinstance(hw, CudaHardwareConfig):
        sub, lane = hw.sublane_align(workload.dtype), hw.lane_align(workload.dtype)
    out = []
    for v in cands:
        if workload.op in ("matmul", "qmatmul"):
            m, n, k = dims
            bm, bn, bk = v.block
            ok = bm <= round_up(m, sub) and bn <= round_up(n, lane) and bk <= round_up(k, lane)
        elif workload.op == "gemv":
            n, k = dims
            bn, bk = v.block
            ok = bn <= round_up(n, 128) and bk <= round_up(k, 128)
        elif workload.op == "vmacc":
            r, c = dims
            br, bc = v.block
            ok = br <= round_up(r, 8) and bc <= round_up(c, 128)
        elif workload.op == "attention":
            _b, _hq, _hkv, ql, kl, _d = dims
            bq, bkv = v.block
            ok = bq <= round_up(ql, 128) and bkv <= round_up(kl, 128)
        else:
            ok = False
        if ok:
            out.append(v)
    if not out:  # guarantee at least the minimal variant matches
        out = [cands[-1]]
    return tuple(out)


def variants_for(workload: Workload, hw: HardwareConfig) -> list[IntrinsicVariant]:
    """MetaSchedule-style matching: keep variants whose block can tile the
    (padded) workload. Oversized variants are dropped, exactly as a VL=VLMAX
    intrinsic cannot match a small operator in the paper. Memoized per
    (workload, hardware) — both frozen — for the same reason as
    :func:`all_variants`: trace replay consults it per candidate set."""
    return list(_variants_for_cached(workload, hw))
