"""The multiply-accumulate: ``a * b + c`` over (rows, cols), with dims
(rows, cols). Its input rule, plain reference, control, comparison, bytes
and operations.

Plain PyTorch, importing nothing of the program. The reference is float64;
the comparison reads ``|out - ref| / (|a*b| + |c|)``, at most 2**-24 = 6.0e-8
for one float32 rounding of a fused multiply-add and 1.2e-7 for two (a
product, then a sum). The bfloat16 control reads about 1.2e-2.
"""

from __future__ import annotations

import torch

# The limit lies between the program's readings (at most 5.96e-8 over a
# dozen seeds at the cells' sizes) and the control's (1.23e-2 and more),
# with more room above the first: PERF.md gives the readings.
NUMBER, LIMIT, COMBINE = "vmacc_rel_err", 1e-4, "max"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(dims, dtype: str, assumed: dict, gen, device: str) -> tuple:
    """a, b and c normal, of standard deviation ``vmacc_std``."""
    std = assumed["vmacc_std"]
    return tuple((torch.randn(tuple(dims), generator=gen, device=device,
                              dtype=torch.float32) * std).to(_DTYPES[dtype])
                 for _ in range(3))


def reference(args, assumed: dict) -> torch.Tensor:
    a, b, c = (t.to(torch.float64) for t in args)
    return a * b + c


def control(args, assumed: dict) -> torch.Tensor:
    """The reference in bfloat16: the precision below float32."""
    a, b, c = (t.to(torch.bfloat16) for t in args)
    return (a * b + c).to(torch.float32)


def error(got: torch.Tensor, want: torch.Tensor, args) -> float:
    if got.shape != want.shape:
        return float("inf")
    a, b, c = (t.to(torch.float64) for t in args)
    scale = ((a * b).abs() + c.abs()).clamp_min(1e-30)
    return float(((got.to(torch.float64) - want).abs() / scale).max())


def op_bytes(dims, dtype: str) -> float:
    """a, b and c read once, the output written."""
    rows, cols = dims
    return 4 * torch.finfo(_DTYPES[dtype]).bits // 8 * rows * cols


def op_ops(dims) -> float:
    rows, cols = dims
    return 2.0 * rows * cols
