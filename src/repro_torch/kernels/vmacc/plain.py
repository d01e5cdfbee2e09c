"""Plain PyTorch version of the multiply-accumulate kernel.

The Pallas kernel computes ``a * b + c`` on each (br, bc) block, and a block
changes no element's arithmetic, so the plain version is the whole-array
expression: the product rounded to the dtype, then the sum (two eager
operations, as ``interpret=True`` evaluates them). The CPU path of the
wrapper and ``EmulateRunner`` use it; on the card only ``chip_smoke.py``
and the card tests run it, to hold the CUDA kernel against it.
"""

from __future__ import annotations

import torch


def vmacc_plain(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    return a * b + c
