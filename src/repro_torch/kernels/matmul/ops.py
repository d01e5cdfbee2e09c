"""Public wrapper of the matmul kernels: pad -> kernel -> slice, per a
schedule, plus the kernels' block-shape gate, their shared-memory
footprint and the Python mirror of the f32 launcher's layout rules
(``csrc/matmul.cu``: ``f32_plan``)."""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.space import KernelParams
from repro_torch.core.workload import dtype_bytes
from repro_torch.kernels import Family
from repro_torch.kernels.matmul.ref import matmul_ref

# The int8 kernels' thread layout (csrc/tile.cuh): a 4x4 register
# micro-tile per thread and at most 1024 threads per block.
MICRO_TILE = 4
MAX_THREADS = 1024
# The tensor-core kernels (csrc/matmul.cu): 16x16 mma fragments, at most
# 16384 outputs a block (64 fragments, 32 warps). bf16: a two-stage
# cp.async ring, shared rows padded by 8 values.
MMA_FRAGMENT = 16
MAX_OUTPUTS = 16384
TC_STAGES = 2
TC_ROW_PAD = 8
# f32 (3xTF32): an F32_STAGES-deep ring, x rows padded by F32_X_PAD floats
# and w rows by F32_W_PAD; a block keeps F32_MIN_WARPS warps where its tile
# allows, and at most F32_MAX_WIDE_WARPS with 1x2 or 2x1 warp tiles;
# _acc_kernel splits K over a cluster of at most F32_MAX_CLUSTER
# blocks while the grid stays within F32_FILL_CTAS (the H100's 132 SMs) and
# each block keeps F32_MIN_STEPS k steps.
F32_STAGES = 3
F32_X_PAD = 4
F32_W_PAD = 8
F32_MIN_WARPS = 4
F32_MAX_WIDE_WARPS = 16
F32_MAX_CLUSTER = 8
F32_FILL_CTAS = 132
F32_MIN_STEPS = 2

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "int32": torch.int32}


def smem_bytes(bm: int, bn: int, bk: int, dtype: str) -> int:
    """Dynamic shared memory of one block, nondecreasing in each block dim
    (the static analyzer's floor relies on it). bf16 (csrc/matmul.cu:
    tc_smem_bytes): two stages of the x tile and the w tile, each row padded
    by 8 values. f32 (f32_smem_bytes): three stages, x rows padded by 4
    floats and w rows by 8, or the partial tile a cluster reduces,
    whichever is larger. int8 (csrc/tile.cuh: smem_bytes): the x tile, its
    rows padded by one 32-bit word, and the w tile."""
    if dtype == "bfloat16":
        return TC_STAGES * (bm * (bk + TC_ROW_PAD)
                            + bk * (bn + TC_ROW_PAD)) * 2
    if dtype == "float32":
        ring = F32_STAGES * (bm * (bk + F32_X_PAD) + bk * (bn + F32_W_PAD))
        return max(ring, bm * bn) * 4
    ib = dtype_bytes(dtype)
    return (bm * (bk + 4 // ib) + bk * bn) * ib


def supports_block_shape(bm: int, bn: int, bk: int, dtype: str,
                         smem_limit: int) -> bool:
    """Can the CUDA kernels launch a (bm, bn, bk) block?

    - f32 and bf16 (tensor cores): bm, bn and bk are multiples of the
      16x16 mma fragment and bm * bn <= 16384 (at most 64 fragments, 32
      warps);
    - int8 (CUDA cores): bm and bn are multiples of the 4x4 per-thread
      micro-tile, and the block's (bm/4) x (bn/4) threads number at most
      1024: the register accumulator holds bm * bn <= 16384 outputs; it
      steps k four at a time (``__dp4a``): bk % 4 == 0;
    - the block's shared memory (``smem_bytes``) fits ``smem_limit`` bytes.
    """
    if min(bm, bn, bk) < 1:
        return False
    if dtype in ("bfloat16", "float32"):
        if bm % MMA_FRAGMENT or bn % MMA_FRAGMENT or bk % MMA_FRAGMENT:
            return False
    elif bm % MICRO_TILE or bn % MICRO_TILE:
        return False
    if bm * bn > MAX_OUTPUTS:
        return False
    if dtype in ("int8", "uint8") and bk % 4:
        return False
    return smem_bytes(bm, bn, bk, dtype) <= smem_limit


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-time layout ``f32_plan`` in ``csrc/matmul.cu`` computes
    for the f32 kernels."""
    wmf: int       # 16x16 fragments per warp tile, down the rows
    wnf: int       # and across the columns
    rep: int       # warp tiles per warp
    warps: int
    tiles: int     # output tiles
    steps: int     # k steps of bk
    cluster: int   # blocks that split one tile's k steps


def plan(pm: int, pn: int, pk: int, bm: int, bn: int, bk: int,
         accumulate: bool, max_cluster: int = F32_MAX_CLUSTER) -> Plan:
    """The f32 kernel's layout for padded ``(pm, pn, pk)`` at block ``(bm,
    bn, bk)``: the rules of ``f32_plan``, step for step (``max_cluster`` as
    ``matmul_launch_capped`` takes it)."""
    fm, fn = bm // MMA_FRAGMENT, bn // MMA_FRAGMENT
    wmf = 2 if fm % 2 == 0 and (fm // 2) * fn >= F32_MIN_WARPS else 1
    wnf = 2 if fn % 2 == 0 and (fm // wmf) * (fn // 2) >= F32_MIN_WARPS \
        else 1
    if wmf * wnf == 2 and (fm // wmf) * (fn // wnf) > F32_MAX_WIDE_WARPS:
        wmf = wnf = 1
    warp_tiles = (fm // wmf) * (fn // wnf)
    rep = 2 if warp_tiles > 32 else 1
    tiles, steps = (pm // bm) * (pn // bn), pk // bk
    c = 1
    while (accumulate and c < max_cluster and tiles * 2 * c <= F32_FILL_CTAS
           and steps >= 2 * c * F32_MIN_STEPS):
        c *= 2
    return Plan(wmf=wmf, wnf=wnf, rep=rep, warps=-(-warp_tiles // rep),
                tiles=tiles, steps=steps, cluster=c)


def k_steps(steps: int, cluster: int, rank: int) -> range:
    """The k steps block ``rank`` of a cluster takes (a contiguous share)."""
    return range(rank * steps // cluster, (rank + 1) * steps // cluster)


_F32_MANGLED = re.compile(
    r"matmul_3xtf32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
_BF16_MANGLED = re.compile(
    r"matmul_tc_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
# A TF32 tensor-core product in SASS (HMMA.1688.F32.TF32 for m16n8k8).
HMMA_TF32 = re.compile(r"\bHMMA\.\d+\.F32\.TF32\b")


def _label(pattern: re.Pattern, name: str, mangled: str) -> str | None:
    m = pattern.search(mangled)
    if m is None:
        return None
    return (f"{name}<{m[1]},{m[2]},{m[3]},"
            f"{'acc' if m[4] == '1' else 'noacc'}>")


def kernel_label(mangled: str) -> str | None:
    """``matmul_3xtf32_kernel<WMF,WNF,REP,acc|noacc>`` for the mangled name
    of one of ``csrc/matmul.cu``'s f32 kernels, else None."""
    return _label(_F32_MANGLED, "matmul_3xtf32_kernel", mangled)


def bf16_kernel_label(mangled: str) -> str | None:
    """``matmul_tc_kernel<WMF,WNF,REP,acc|noacc>`` for the mangled name of
    one of ``csrc/matmul.cu``'s bf16 kernels, else None."""
    return _label(_BF16_MANGLED, "matmul_tc_kernel", mangled)


def pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - a.shape[0], cols - a.shape[1]
    if pr or pc:
        a = F.pad(a, (0, pc, 0, pr))
    return a


def build(params: KernelParams, device: str = "cuda"):
    """``f(x, w) -> x @ w`` for this schedule, on ``device``: inputs (numpy
    arrays or tensors) are moved there and cast to the workload dtype,
    padded, multiplied by the kernel and sliced. The result is f32 or int32
    unless the workload's out dtype is narrower (bf16 casts back)."""
    from repro_torch.kernels.matmul.kernel import matmul_blocked

    m, n, _k = params.dims
    pm, pn, pk = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def f(x, w):
        with tracing.span("matmul.call"):
            x = pad2(torch.as_tensor(x, device=device).to(compute), pm, pk)
            w = pad2(torch.as_tensor(w, device=device).to(compute), pk, pn)
            out = matmul_blocked(x.contiguous(), w.contiguous(), params.block,
                                 params.order, params.accumulate)
            out = out[:m, :n]
            if params.out_dtype not in ("int32", "float32"):
                out = out.to(TORCH_DTYPES[params.out_dtype])
            return out

    return f


def baseline(workload):
    """``torch.matmul`` in the workload dtype; :func:`int_mm` for int8."""
    dtype = TORCH_DTYPES[workload.dtype]
    if dtype == torch.int8:
        return int_mm
    return lambda x, w: torch.matmul(x.to(dtype), w.to(dtype))


# (rows, k, n, device type) -> the padded shape ``torch._int_mm`` is called
# at for it (the shape itself when it takes it).
_INT_MM_SHAPES: dict[tuple, tuple[int, int, int]] = {}


def int_mm(x, w):
    """``torch._int_mm(x, w)`` for any shape. On the card it takes only
    more than 16 rows and k and n multiples of 8, and cuBLASLt refuses some
    shapes within those limits too (``CUBLAS_STATUS_NOT_SUPPORTED`` for
    MobileNetV2's 784 x 144 x 24, and for it padded to 784 x 144 x 32). The
    call tries the shape itself, then zero-padded to multiples of 16, then
    of 128, and remembers per shape the first one that runs."""
    m, k = x.shape
    n = w.shape[1]
    key = (m, k, n, x.device.type)
    if key in _INT_MM_SHAPES:
        return _int_mm_at(x, w, _INT_MM_SHAPES[key])
    tries = [(m, k, n)] + [tuple(d + (-d) % g for d in (max(m, 17), k, n))
                           for g in (16, 128)]
    for i, shape in enumerate(tries):
        try:
            out = _int_mm_at(x, w, shape)
        except RuntimeError:
            if i == len(tries) - 1:
                raise
            continue
        _INT_MM_SHAPES[key] = shape
        return out


def _int_mm_at(x, w, shape):
    """``x @ w`` in int32 through ``torch._int_mm`` at ``shape`` (pm, pk,
    pn), zero-padding the operands up to it and slicing the result back."""
    m, k = x.shape
    n = w.shape[1]
    pm, pk, pn = shape
    if shape == (m, k, n):
        return torch._int_mm(x, w)
    xp = F.pad(x, (0, pk - k, 0, pm - m))
    wp = F.pad(w, (0, pn - n, 0, pk - k))
    return torch._int_mm(xp, wp)[:m, :n]


# The family's answers to the tuner (``kernels.family``).
FAMILY = Family(
    gate=lambda wl, block, hw: supports_block_shape(*block, wl.dtype,
                                                    hw.vmem_capacity),
    footprint=lambda wl, block, hw: smem_bytes(*block, wl.dtype),
    build=build, reference=lambda wl: matmul_ref, baseline=baseline)
