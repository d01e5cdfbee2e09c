"""Public wrapper of the matmul kernels: pad -> kernel -> slice, per a
schedule, plus the kernels' block-shape gate."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.space import KernelParams
from repro_torch.core.workload import dtype_bytes

# The f32 and int8 kernels' thread layout (csrc/tile.cuh): a 4x4 register
# micro-tile per thread and at most 1024 threads per block.
MICRO_TILE = 4
MAX_THREADS = 1024
# The bf16 tensor-core kernels (csrc/matmul.cu): 16x16 mma fragments, a
# two-stage cp.async ring, shared rows padded by 8 bf16 values.
MMA_FRAGMENT = 16
TC_STAGES = 2
TC_ROW_PAD = 8

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "int32": torch.int32}


def smem_bytes(bm: int, bn: int, bk: int, dtype: str) -> int:
    """Dynamic shared memory of one block. bf16 (csrc/matmul.cu:
    tc_smem_bytes): two stages of the x tile and the w tile, each row padded
    by 8 values. f32 and int8 (csrc/tile.cuh: smem_bytes): the x tile, its
    rows padded by one 32-bit word, and the w tile."""
    if dtype == "bfloat16":
        return TC_STAGES * (bm * (bk + TC_ROW_PAD)
                            + bk * (bn + TC_ROW_PAD)) * 2
    ib = dtype_bytes(dtype)
    return (bm * (bk + 4 // ib) + bk * bn) * ib


def supports_block_shape(bm: int, bn: int, bk: int, dtype: str,
                         smem_limit: int) -> bool:
    """Can the CUDA kernels launch a (bm, bn, bk) block?

    - bf16 (tensor cores): bm, bn and bk are multiples of the 16x16 mma
      fragment and bm * bn <= 16384 (at most 64 fragments, 32 warps);
    - f32 and int8 (CUDA cores): bm and bn are multiples of the 4x4
      per-thread micro-tile, and the block's (bm/4) x (bn/4) threads number
      at most 1024: the register accumulator holds bm * bn <= 16384
      outputs; int8 steps k four at a time (``__dp4a``): bk % 4 == 0;
    - the block's shared memory (``smem_bytes``) fits ``smem_limit`` bytes.
    """
    if min(bm, bn, bk) < 1:
        return False
    if dtype == "bfloat16":
        if bm % MMA_FRAGMENT or bn % MMA_FRAGMENT or bk % MMA_FRAGMENT:
            return False
    elif bm % MICRO_TILE or bn % MICRO_TILE:
        return False
    if (bm // MICRO_TILE) * (bn // MICRO_TILE) > MAX_THREADS:
        return False
    if dtype in ("int8", "uint8") and bk % 4:
        return False
    return smem_bytes(bm, bn, bk, dtype) <= smem_limit


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
        x = pad2(torch.as_tensor(x, device=device).to(compute), pm, pk)
        w = pad2(torch.as_tensor(w, device=device).to(compute), pk, pn)
        out = matmul_blocked(x.contiguous(), w.contiguous(), params.block,
                             params.order, params.accumulate)
        out = out[:m, :n]
        if params.out_dtype not in ("int32", "float32"):
            out = out.to(TORCH_DTYPES[params.out_dtype])
        return out

    return f
