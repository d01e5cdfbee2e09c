"""Wrapper of the CUDA matrix-vector kernels (``csrc/gemv.cu``).

``gemv_blocked`` is the port of ``_gemv_kernel`` (``accumulate=True``) and
``_gemv_noacc_kernel`` (``accumulate=False``) of the JAX package's
``kernels/gemv/kernel.py``. On a CUDA tensor it launches the kernel
(span ``gemv.launch``) and counts the launch (counter ``launch.<kernel>``,
:mod:`repro_torch.tracing`); on a CPU tensor it runs the plain version
(``plain.py``), and only there. The kernels read w with 16-byte
vector loads (each thread owns 16 bytes of neighbouring columns, and the
block's threads split the k rows: ``csrc/gemv.cu``), so a w whose storage
does not start on 16 bytes is copied first.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.gemv import plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.library("gemv")
    if lib.gemv_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.gemv_launch.argtypes = [i, i, p, p, p, i, i, i, i, p]
        lib.gemv_launch.restype = ctypes.c_int
        lib.gemv_launch_capped.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
        lib.gemv_launch_capped.restype = ctypes.c_int
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
                 accumulate: bool = True,
                 max_cluster: int | None = None) -> torch.Tensor:
    """Padded ``x (1, pk) @ w (pk, pn)`` with the schedule's (bn, bk) block
    and accumulate choice; returns the (1, pn) product in float32, for
    bf16 operands too (as the Pallas kernels). ``max_cluster`` caps the
    blocks ``_gemv_kernel`` splits K over (``ops.plan``); None keeps the
    kernel's own rule, 1 splits K over none (for measuring the split)."""
    check_operands(x, w, block)
    bn, bk = block
    if x.device.type == "cpu":
        return plain.gemv_plain(x, w, bk)
    if x.device.type != "cuda":
        raise ValueError(f"no gemv kernel for device {x.device}")
    pk, pn = w.shape
    if w.data_ptr() % 16:   # a view into another tensor's storage
        w = w.clone()
    out = torch.empty((1, pn), dtype=torch.float32, device=x.device)
    lib = _lib()
    args = (int(accumulate), _DTYPE_CODE[x.dtype], x.data_ptr(),
            w.data_ptr(), out.data_ptr(), pn, pk, bn, bk)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    name = "_gemv_kernel" if accumulate else "_gemv_noacc_kernel"
    with tracing.span("gemv.launch"):
        if max_cluster is None:
            code = lib.gemv_launch(*args, stream)
        else:
            code = lib.gemv_launch_capped(*args, max_cluster, stream)
        _build.check(lib, name, code)
    tracing.count("launch." + name)
    return out
