"""Public wrapper of the GEMV kernels: pad -> kernel -> slice, per a
schedule, plus the kernels' block-shape gate."""

from __future__ import annotations

import torch

from repro_torch.core.space import KernelParams
from repro_torch.kernels.matmul.ops import TORCH_DTYPES, pad2

# csrc/gemv.cu: a block runs at most one thread per output column, and a
# block has at most 1024 threads.
MAX_BN = 1024


def supports_block_shape(bn: int, bk: int, lane: int) -> bool:
    """Can the GEMV kernels take a (bn, bk) block?

    The reference's rule (its ``gemv/ops.py``): ``bk`` a positive lane
    multiple, ``bn`` a lane multiple (a full output tile per step) or
    exactly 1 (the paper's J = 1 row kernel). The CUDA kernel adds its own
    limit: ``bn <= MAX_BN`` threads. On the TPU configs that limit never
    binds (their ``bn`` candidates stop at 8 lanes, 1024), so their design
    spaces stay the reference's.
    """
    if bn < 1 or bk < 1:
        return False
    if bk % lane:
        return False
    return (bn == 1 or bn % lane == 0) and bn <= MAX_BN


def build(params: KernelParams, device: str = "cuda"):
    """``f(x, w) -> x @ w`` for this schedule, on ``device``: inputs (numpy
    arrays or tensors) are moved there and cast to the workload dtype,
    padded, multiplied by the kernel and sliced to ``(1, n)``. The result
    is float32 whatever the workload dtype, as the reference's."""
    from repro_torch.kernels.gemv.kernel import gemv_blocked

    n, _k = params.dims
    pn, pk = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def f(x, w):
        x = pad2(torch.as_tensor(x, device=device).to(compute), 1, pk)
        w = pad2(torch.as_tensor(w, device=device).to(compute), pk, pn)
        out = gemv_blocked(x.contiguous(), w.contiguous(), params.block,
                           params.accumulate)
        return out[:, :n]

    return f
