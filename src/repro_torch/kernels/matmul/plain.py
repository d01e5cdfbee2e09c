"""Plain PyTorch version of the tiled matmul kernels.

It runs the Pallas grid's arithmetic (``interpret=True`` in the JAX
package): for each k block in order, the block product in the accumulator
type, added to the running sum. Both Pallas kernels do exactly that per
output element — ``_acc_kernel`` into a VMEM accumulator, ``_noacc_kernel``
into the output buffer — so one function stands for both. Tiling in m and
n changes no element's arithmetic, so the block product runs over the full
width.

The CPU path of the kernel wrappers and ``EmulateRunner`` use it; on the
card only ``chip_smoke.py`` runs it, to hold the CUDA kernels against it.
"""

from __future__ import annotations

import torch


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if dtype in (torch.int8, torch.uint8) else torch.float32


def block_product(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One k block's product in the accumulator type. PyTorch has no
    integer matmul on CUDA, so int8 blocks multiply in float64, which is
    exact here (|x|, |w| <= 128 and bk <= 2^20 keep every sum below
    2^53), then convert to int32."""
    if xb.dtype in (torch.int8, torch.uint8):
        return (xb.double() @ wb.double()).to(torch.int32)
    return xb.float() @ wb.float()


def matmul_plain(x: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """Padded ``x (pm, pk) @ w (pk, pn)`` in the accumulator type (f32, or
    int32 for int8), summed block by block over k in ``bk`` steps."""
    pm, pk = x.shape
    acc = torch.zeros((pm, w.shape[1]), dtype=accumulator_dtype(x.dtype),
                      device=x.device)
    for k0 in range(0, pk, bk):
        acc += block_product(x[:, k0:k0 + bk], w[k0:k0 + bk, :])
    return acc
