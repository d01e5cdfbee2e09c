"""Plain PyTorch version of the matrix-vector kernels.

It runs the Pallas grid's arithmetic (``interpret=True`` in the JAX
package): for each k block in order, the block product in float32, added to
the running sum. ``_gemv_kernel`` sums into a VMEM accumulator and
``_gemv_noacc_kernel`` into the output buffer, the same arithmetic per
output element, so one function stands for both; tiling in n changes no
element's arithmetic, so the block product runs over the full width.

The CPU path of the kernel wrapper and ``EmulateRunner`` use it; on the
card only ``chip_smoke.py`` and the card tests run it, to hold the CUDA
kernels against it.
"""

from __future__ import annotations

import torch


def gemv_plain(x: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """Padded ``x (1, pk) @ w (pk, pn)`` in float32, summed block by block
    over k in ``bk`` steps."""
    pk, pn = w.shape
    acc = torch.zeros((1, pn), dtype=torch.float32, device=x.device)
    for k0 in range(0, pk, bk):
        acc += x[:, k0:k0 + bk].float() @ w[k0:k0 + bk, :].float()
    return acc
