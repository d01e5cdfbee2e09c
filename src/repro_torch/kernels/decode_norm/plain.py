"""Plain PyTorch version of the decode-step norm kernel
(``csrc/decode_norm.cu``): a residual add and the RMSNorm after it.

It runs ``models/layers.py``'s arithmetic op for op: ``s = x + y`` in x's
dtype, then ``rms_norm(s)``: the f32 upcast, the mean of squares, ``rsqrt(var
+ eps)``, the product with the f32 scale and one cast back. On the CPU it
gives the eager path's bits; the kernel differs from it only in the order of
its f32 sum of squares.

Only the tests and ``chip_smoke.py`` run it: on the CPU against the eager
functions, on the card to hold the kernel against it.
"""

from __future__ import annotations

import torch


def decode_norm_plain(x: torch.Tensor, y: torch.Tensor | None,
                      scale: torch.Tensor, eps: float):
    """``(x + y, rms_norm(x + y))`` in x's dtype; ``(x, rms_norm(x))``
    where ``y`` is None."""
    s = x if y is None else x + y
    xf = s.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return s, out.to(s.dtype)
