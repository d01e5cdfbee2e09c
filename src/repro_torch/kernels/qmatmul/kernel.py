"""Wrapper of the CUDA quantized matmul kernel (``csrc/qmatmul.cu``).

``qmatmul_blocked`` is the port of ``_qmm_kernel`` of the JAX package's
``kernels/qmatmul/kernel.py``. Like it, it ignores the schedule's order
and accumulate decisions. On a CUDA tensor it launches the kernel and counts
the launch in :data:`launches`; on a CPU tensor it runs the plain version
(``plain.py``), and only there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.kernel import check_operands
from repro_torch.kernels.qmatmul import plain

# Launches since the last reset (kernels.reset_launch_counts).
launches = {"_qmm_kernel": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.library("qmatmul")
    if lib.qmatmul_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.qmatmul_launch.argtypes = [p, p, p, ctypes.c_float, p, i, i, i,
                                       i, i, i, p]
        lib.qmatmul_launch.restype = ctypes.c_int
    return lib


def qmatmul_blocked(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    scale: float, block: tuple[int, int, int]) -> torch.Tensor:
    """Padded int8 ``requant(x @ w + bias)``; returns (pm, pn) int8."""
    check_operands(x, w, block)
    if x.dtype != torch.int8:
        raise ValueError(f"qmatmul takes int8 operands, got {x.dtype}")
    pn = w.shape[1]
    if bias.shape != (pn,) or bias.dtype != torch.int32 \
            or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous ({pn},) int32 tensor "
                         f"on {x.device}")
    bm, bn, bk = block
    if x.device.type == "cpu":
        return plain.qmatmul_plain(x, w, bias, scale, bk)
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul kernel for device {x.device}")
    pm, pk = x.shape
    out = torch.empty((pm, pn), dtype=torch.int8, device=x.device)
    lib = _lib()
    code = lib.qmatmul_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale, out.data_ptr(),
        pm, pn, pk, bm, bn, bk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "_qmm_kernel", code)
    launches["_qmm_kernel"] += 1
    return out
