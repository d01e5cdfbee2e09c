"""Wrapper of the CUDA matrix-vector kernels (``csrc/gemv.cu``).

``gemv_blocked`` is the port of ``_gemv_kernel`` (``accumulate=True``) and
``_gemv_noacc_kernel`` (``accumulate=False``) of the JAX package's
``kernels/gemv/kernel.py``. On a CUDA tensor it launches the kernel and
counts the launch in :data:`launches`; on a CPU tensor it runs the plain
version (``plain.py``), and only there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv import plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last reset (kernels.reset_launch_counts).
launches = {"_gemv_kernel": 0, "_gemv_noacc_kernel": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.library("gemv")
    if lib.gemv_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.gemv_launch.argtypes = [i, i, p, p, p, i, i, i, i, p]
        lib.gemv_launch.restype = ctypes.c_int
    return lib


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   block: tuple[int, int]) -> None:
    """Raise unless ``x (1, pk)`` and ``w (pk, pn)`` are contiguous 2-D
    tensors of one supported dtype on one device, tiled exactly by
    ``block = (bn, bk)``."""
    bn, bk = block
    if x.dim() != 2 or w.dim() != 2 or x.shape[0] != 1 \
            or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if bn < 1 or bk < 1 or w.shape[1] % bn or w.shape[0] % bk:
        raise ValueError(f"block {block} does not tile {w.shape[1]}x"
                         f"{w.shape[0]}")


def gemv_blocked(x: torch.Tensor, w: torch.Tensor, block: tuple[int, int],
                 accumulate: bool = True) -> torch.Tensor:
    """Padded ``x (1, pk) @ w (pk, pn)`` with the schedule's (bn, bk) block
    and accumulate choice; returns the (1, pn) product in float32, for
    bf16 operands too (as the Pallas kernels)."""
    check_operands(x, w, block)
    bn, bk = block
    if x.device.type == "cpu":
        return plain.gemv_plain(x, w, bk)
    if x.device.type != "cuda":
        raise ValueError(f"no gemv kernel for device {x.device}")
    pk, pn = w.shape
    out = torch.empty((1, pn), dtype=torch.float32, device=x.device)
    lib = _lib()
    code = lib.gemv_launch(
        int(accumulate), _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), pn, pk, bn, bk,
        torch.cuda.current_stream(x.device).cuda_stream)
    name = "_gemv_kernel" if accumulate else "_gemv_noacc_kernel"
    _build.check(lib, name, code)
    launches[name] += 1
    return out
