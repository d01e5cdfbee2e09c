"""Plain PyTorch version of the quantized matmul kernel.

The Pallas grid's arithmetic (``interpret=True`` in the JAX package): the
int32 product summed block by block over k, then the requantization of the
last k step. The CPU path of the wrapper and ``EmulateRunner`` use it; on
the card only ``chip_smoke.py`` runs it, to hold the CUDA kernel against
it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul.plain import matmul_plain


def requantize(acc: torch.Tensor, bias: torch.Tensor,
               scale: float) -> torch.Tensor:
    """int32 accumulator + int32 bias, times the f32 scale, rounded half to
    even (``torch.round``, as ``jnp.round``), clipped to int8. PyTorch
    multiplies an f32 tensor by a Python scalar in f32 (the scalar is
    rounded to f32 first), as the JAX kernel multiplies by its f32 scale."""
    scaled = (acc + bias.to(torch.int32)).to(torch.float32) * scale
    return torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)


def qmatmul_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  scale: float, bk: int) -> torch.Tensor:
    """Padded int8 ``x (pm, pk) @ w (pk, pn) + bias (pn,)``, requantized."""
    return requantize(matmul_plain(x, w, bk), bias[None, :], scale)
