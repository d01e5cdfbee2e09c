"""The int8 quantized matmul: ``requant(x (m, k) @ w (k, n) + bias (n,))``
with dims (m, n, k). Its input rule, plain reference, control, comparison,
bytes and operations.

Plain PyTorch, importing nothing of the program: the op is written again
from its definition (int32 products summed, the int32 bias added, one
float32 multiply by the scale, round half to even, clip to int8). Float64
holds the products' sums exactly (they stay far below 2**53).
"""

from __future__ import annotations

import math

import torch

# int8 outputs that differ from the reference's; the op is exact.
NUMBER, LIMIT, COMBINE = "qmm_mismatched", 0, "sum"


def operand_range(k: int, out_std: float, scale: float) -> int:
    """The a of x, w in [-a, a]: a(a+1) = 300 * out_std / sqrt(k) makes
    ``(x @ w) * scale`` spread with a standard deviation of ``out_std`` at
    ``scale`` 0.01, as a calibrated network's requantized outputs do."""
    target = out_std / scale * 3.0 / math.sqrt(k)
    a = int(round((math.sqrt(1.0 + 4.0 * target) - 1.0) / 2.0))
    return max(1, min(a, 127))


def inputs(dims, dtype: str, assumed: dict, gen, device: str) -> tuple:
    """x, w uniform integers in [-a, a]; bias uniform in
    [-qmatmul_bias_range, qmatmul_bias_range]."""
    m, n, k = dims
    a = operand_range(k, assumed["qmatmul_out_std"], assumed["requant_scale"])
    x = torch.randint(-a, a + 1, (m, k), generator=gen, device=device,
                      dtype=torch.int8)
    w = torch.randint(-a, a + 1, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    r = assumed["qmatmul_bias_range"]
    bias = torch.randint(-r, r + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    return x, w, bias


def requantize(acc: torch.Tensor, bias: torch.Tensor,
               scale: float) -> torch.Tensor:
    scaled = (acc + bias.to(torch.int64)[None, :]).to(torch.float32) \
        * torch.tensor(scale, dtype=torch.float32)
    return torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)


def reference(args, assumed: dict) -> torch.Tensor:
    x, w, bias = args
    acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    return requantize(acc, bias, assumed["requant_scale"])


def to_int4(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the 16 levels an int4 operand with one scale holds."""
    step = max(float(t.abs().max()), 1.0) / 7.0
    return torch.clamp(torch.round(t.to(torch.float64) / step), -8, 7) * step


def control(args, assumed: dict) -> torch.Tensor:
    """The reference on int4 operands: the precision below int8."""
    x, w, bias = args
    acc = torch.round(to_int4(x) @ to_int4(w)).to(torch.int64)
    return requantize(acc, bias, assumed["requant_scale"])


def error(got: torch.Tensor, want: torch.Tensor, args) -> float:
    if got.shape != want.shape:
        return float(want.numel())
    return float((got.to(want.device) != want).sum())


def op_bytes(dims, dtype: str) -> float:
    """x and w read once, the int32 bias read once, the output written."""
    m, n, k = dims
    return m * k + k * n + 4 * n + m * n


def op_ops(dims) -> float:
    m, n, k = dims
    return 2.0 * m * n * k
