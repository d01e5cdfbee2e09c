"""Wrapper of the CUDA quantized matmul kernel (``csrc/qmatmul.cu``).

``qmatmul_ragged`` and ``qmatmul_blocked`` are the port of ``_qmm_kernel`` of
the JAX package's ``kernels/qmatmul/kernel.py``: one kernel, on the
tensor cores, that takes the operands at their real size (``ragged``, what
``ops.build`` calls) or padded to the block (``blocked``, the Pallas
kernel's contract). Like the Pallas kernel it ignores the schedule's order
and accumulate decisions. On a CUDA tensor either launches the kernel
(span ``qmatmul.launch``) and counts the launch (counter
``launch._qmm_kernel``, and ``launch._qmm_kernel.wgmma`` where the launcher
took its wgmma loop, :mod:`repro_torch.tracing`); on a CPU tensor it
runs the plain version (``plain.py``), and only there. A block the kernel
cannot launch raises ``KernelLaunchError``, with no fallback to another
path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.matmul.kernel import check_operands
from repro_torch.kernels.qmatmul import plain
from repro_torch.kernels.qmatmul.ops import MAX_CLUSTER


def _lib() -> ctypes.CDLL:
    lib = _build.library("qmatmul")
    if lib.qmatmul_launch_capped.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.qmatmul_launch_capped.argtypes = [p, p, p, ctypes.c_float, p, i,
                                              i, i, i, i, i, i, p,
                                              ctypes.POINTER(i)]
        lib.qmatmul_launch_capped.restype = ctypes.c_int
    return lib


def _check_bias(x: torch.Tensor, bias: torch.Tensor, n: int) -> None:
    if bias.shape != (n,) or bias.dtype != torch.int32 \
            or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous ({n},) int32 tensor "
                         f"on {x.device}")


def _launch(x, w, bias, scale, block, max_cluster):
    """Launch the kernel on ``x (m, k) @ w (k, n)`` as they are."""
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    lib = _lib()
    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale,
            out.data_ptr(), m, n, k, *block)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wgmma = ctypes.c_int()
    with tracing.span("qmatmul.launch"):
        cap = MAX_CLUSTER if max_cluster is None else max_cluster
        code = lib.qmatmul_launch_capped(*args, cap, stream,
                                         ctypes.byref(wgmma))
        _build.check(lib, "_qmm_kernel", code)
    tracing.count("launch._qmm_kernel")
    if wgmma.value:
        tracing.count("launch._qmm_kernel.wgmma")
    return out


def qmatmul_ragged(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   scale: float, block: tuple[int, int, int],
                   max_cluster: int | None = None) -> torch.Tensor:
    """int8 ``requant(x (m, k) @ w (k, n) + bias (n,))`` at any ``m``, ``n``,
    ``k``; returns (m, n) int8. ``block`` sets each block's output tile and
    k step; the kernel masks the tail tiles. ``max_cluster`` caps the blocks
    that split K (``ops.plan``); None keeps the kernel's own rule, 1 splits
    K over none."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or 0 in (*x.shape, w.shape[1]):
        raise ValueError(f"bad operand shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"qmatmul takes int8 operands, got {x.dtype}, "
                         f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    _check_bias(x, bias, w.shape[1])
    if x.device.type == "cpu":
        return plain.qmatmul_plain(x, w, bias, scale, block[2])
    return _launch(x, w, bias, scale, block, max_cluster)


def qmatmul_blocked(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    scale: float, block: tuple[int, int, int]) -> torch.Tensor:
    """Padded int8 ``requant(x @ w + bias)``; returns (pm, pn) int8."""
    check_operands(x, w, block)
    if x.dtype != torch.int8:
        raise ValueError(f"qmatmul takes int8 operands, got {x.dtype}")
    _check_bias(x, bias, w.shape[1])
    if x.device.type == "cpu":
        return plain.qmatmul_plain(x, w, bias, scale, block[2])
    return _launch(x, w, bias, scale, block, None)
