"""Public wrapper of the quantized matmul kernel: pad -> kernel -> slice.

The kernel shares the matmul kernels' tiling (csrc/tile.cuh), so its
block-shape gate is ``matmul.ops.supports_block_shape`` at int8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.space import KernelParams
from repro_torch.kernels.matmul.ops import pad2

DEFAULT_SCALE = 0.01


def build(params: KernelParams, device: str = "cuda",
          scale: float = DEFAULT_SCALE):
    """``f(x, w, bias) -> requant(x @ w + bias)`` (int8) for this schedule,
    on ``device``."""
    from repro_torch.kernels.qmatmul.kernel import qmatmul_blocked

    m, n, _ = params.dims
    pm, pn, pk = params.padded_dims

    def f(x, w, bias):
        x = pad2(torch.as_tensor(x, device=device), pm, pk)
        w = pad2(torch.as_tensor(w, device=device), pk, pn)
        bias = torch.as_tensor(bias, device=device)
        if bias.shape[0] != pn:
            bias = F.pad(bias, (0, pn - bias.shape[0]))
        out = qmatmul_blocked(x.contiguous(), w.contiguous(),
                              bias.contiguous(), scale, params.block)
        return out[:m, :n]

    return f
