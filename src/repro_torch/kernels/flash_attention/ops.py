"""Public wrapper of the flash-attention kernel: cast -> reshape -> pad ->
kernel -> slice, per a schedule, plus the kernel's block-shape gate."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.space import KernelParams
from repro_torch.core.workload import dtype_bytes
from repro_torch.kernels.matmul.ops import TORCH_DTYPES


def smem_bytes(bq: int, bkv: int, pd: int, dtype: str) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu:
    fa_smem_bytes): the q, transposed k (one padding column) and v tiles in
    the input dtype, rounded up to 16 bytes, then the f32 scores (bq, bkv),
    accumulator (bq, pd) and running max and sum (bq each)."""
    tiles = (bq * pd + pd * (bkv + 1) + bkv * pd) * dtype_bytes(dtype)
    tiles = -(-tiles // 16) * 16
    return tiles + (bq * bkv + bq * pd + 2 * bq) * 4


def supports_block_shape(bq: int, bkv: int, pd: int, dtype: str,
                         smem_limit: int) -> bool:
    """Can the CUDA kernel launch a (bq, bkv) block at padded head dim
    ``pd``? The kernel runs 256 threads whatever the block (each warp loops
    over its rows, each lane over its columns), so neither a thread limit
    nor a grain binds: only positive extents and its shared memory, which
    must fit ``smem_limit`` bytes."""
    if min(bq, bkv, pd) < 1:
        return False
    return smem_bytes(bq, bkv, pd, dtype) <= smem_limit


def pad_operands(params: KernelParams, q, k, v, device: str = "cuda"):
    """q (B, Hq, Lq, D) and k, v (B, Hkv, Lkv, D) (numpy arrays or tensors)
    as the kernel takes them: on ``device``, in the workload dtype,
    flattened to (B*H, L, D) and zero-padded to ``params.padded_dims``."""
    b, hq, hkv, lq, lkv, d = params.dims
    _, _, _, pq, pkv, pd = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def prep(t, heads, length, padded):
        t = torch.as_tensor(t, device=device).to(compute)
        t = t.reshape(b * heads, length, d)
        if padded != length or pd != d:
            t = F.pad(t, (0, pd - d, 0, padded - length))
        return t.contiguous()

    return prep(q, hq, lq, pq), prep(k, hkv, lkv, pkv), prep(v, hkv, lkv, pkv)


def build(params: KernelParams, device: str = "cuda"):
    """``f(q, k, v) -> attention`` for this schedule, on ``device``: the
    operands are padded (:func:`pad_operands`), run through the kernel,
    sliced and reshaped back to (B, Hq, Lq, D). The output is in the
    workload dtype, as the reference's."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_blocked

    b, hq, _, lq, _, d = params.dims

    def f(q, k, v):
        o = flash_attention_blocked(*pad_operands(params, q, k, v, device),
                                    params)
        return o[:, :lq, :d].reshape(b, hq, lq, d)

    return f
