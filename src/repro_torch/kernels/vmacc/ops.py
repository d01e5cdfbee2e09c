"""Public wrapper of the vmacc kernel: pad -> kernel -> slice, per a
schedule, plus the kernel's block-shape gate."""

from __future__ import annotations

import torch

from repro_torch.core.space import KernelParams
from repro_torch.kernels.matmul.ops import TORCH_DTYPES, pad2


def supports_block_shape(br: int, bc: int, sub: int, lane: int) -> bool:
    """Can the vmacc kernel take a (br, bc) block?

    The reference's rule (its ``vmacc/ops.py``): a positive block whose rows
    are a sublane multiple and whose columns are a lane multiple. The CUDA
    kernel adds no limit of its own: a block of 256 threads walks a tile of
    any size (``csrc/vmacc.cu``), holding nothing in shared memory.
    """
    if br < 1 or bc < 1:
        return False
    return br % sub == 0 and bc % lane == 0


def build(params: KernelParams, device: str = "cuda"):
    """``f(a, b, c) -> a * b + c`` for this schedule, on ``device``: inputs
    (numpy arrays or tensors) are moved there, cast to the workload dtype,
    padded, combined by the kernel and sliced."""
    from repro_torch.kernels.vmacc.kernel import vmacc_blocked

    r, c = params.dims
    pr, pc = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def f(a, b, cc):
        a, b, cc = (pad2(torch.as_tensor(t, device=device).to(compute), pr,
                         pc).contiguous() for t in (a, b, cc))
        return vmacc_blocked(a, b, cc, params.block)[:r, :c]

    return f
