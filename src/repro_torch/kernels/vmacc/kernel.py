"""Wrapper of the CUDA multiply-accumulate kernel (``csrc/vmacc.cu``).

``vmacc_blocked`` is the port of ``_vmacc_kernel`` of the JAX package's
``kernels/vmacc/kernel.py``. On a CUDA tensor it launches the kernel and
counts the launch in :data:`launches`; on a CPU tensor it runs the plain
version (``plain.py``), and only there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vmacc import plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches since the last reset (kernels.reset_launch_counts).
launches = {"_vmacc_kernel": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.library("vmacc")
    if lib.vmacc_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.vmacc_launch.argtypes = [i, p, p, p, p, i, i, i, i, p]
        lib.vmacc_launch.restype = ctypes.c_int
    return lib


def check_operands(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   block: tuple[int, int]) -> None:
    """Raise unless ``a``, ``b`` and ``c`` are contiguous 2-D tensors of one
    shape, one supported dtype and one device, tiled exactly by ``block =
    (br, bc)``."""
    br, bc = block
    if a.dim() != 2 or b.shape != a.shape or c.shape != a.shape:
        raise ValueError(f"bad operand shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if not (a.dtype == b.dtype == c.dtype) or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {a.dtype}, {b.dtype}, "
                         f"{c.dtype}")
    if not (a.device == b.device == c.device):
        raise ValueError(f"operands on {a.device}, {b.device}, {c.device}")
    if not (a.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if br < 1 or bc < 1 or a.shape[0] % br or a.shape[1] % bc:
        raise ValueError(f"block {block} does not tile {tuple(a.shape)}")


def vmacc_blocked(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  block: tuple[int, int]) -> torch.Tensor:
    """Padded ``a * b + c`` over (br, bc) blocks, in the operands' dtype."""
    check_operands(a, b, c, block)
    if a.device.type == "cpu":
        return plain.vmacc_plain(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"no vmacc kernel for device {a.device}")
    pr, pc = a.shape
    out = torch.empty_like(a)
    lib = _lib()
    code = lib.vmacc_launch(
        _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(),
        out.data_ptr(), pr, pc, block[0], block[1],
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, "_vmacc_kernel", code)
    launches["_vmacc_kernel"] += 1
    return out
