"""Wrapper of the CUDA matmul kernels (``csrc/matmul.cu``).

``matmul_blocked`` is the port of ``_acc_kernel`` (``accumulate=True``) and
``_noacc_kernel`` (``accumulate=False``) of the JAX package's
``kernels/matmul/kernel.py``. On a CUDA tensor it launches the kernel and
counts the launch in :data:`launches`; on a CPU tensor it runs the plain
version (``plain.py``), and only there. bf16 and f32 operands run on the
tensor cores (``mma.sync`` from a ``cp.async`` ring: the
``matmul_tc_kernel`` instantiations for bf16, the 3xTF32
``matmul_3xtf32_kernel`` ones for f32, whose ``_acc_kernel`` may split K
over a cluster), int8 on the CUDA cores; a block the kernel cannot launch
raises ``KernelLaunchError``, with no fallback to another path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import ops, plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launches of each kernel since the last reset (kernels.reset_launch_counts).
launches = {"_acc_kernel": 0, "_noacc_kernel": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.library("matmul")
    if lib.matmul_launch_capped.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.matmul_launch_capped.argtypes = [i, i, p, p, p, i, i, i, i, i,
                                             i, i, i, p]
        lib.matmul_launch_capped.restype = ctypes.c_int
    return lib


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   block: tuple[int, int, int]) -> None:
    """Raise unless ``x (pm, pk)`` and ``w (pk, pn)`` are contiguous 2-D
    tensors of one supported dtype on one device, tiled exactly by
    ``block``."""
    bm, bn, bk = block
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    pm, pk = x.shape
    if pm % bm or w.shape[1] % bn or pk % bk:
        raise ValueError(f"block {block} does not tile {pm}x{w.shape[1]}x"
                         f"{pk}")


def matmul_blocked(x: torch.Tensor, w: torch.Tensor,
                   block: tuple[int, int, int], order: str = "mnk",
                   accumulate: bool = True,
                   max_cluster: int = ops.F32_MAX_CLUSTER) -> torch.Tensor:
    """Padded ``x @ w`` with the schedule's block, order and accumulate
    choice; returns the (pm, pn) product in f32 (int32 for int8). The f32
    ``_acc_kernel`` splits K over at most ``max_cluster`` blocks of a
    cluster (1: never), by the rule ``ops.plan`` mirrors."""
    check_operands(x, w, block)
    bm, bn, bk = block
    if x.device.type == "cpu":
        return plain.matmul_plain(x, w, bk)
    if x.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {x.device}")
    pm, pk = x.shape
    pn = w.shape[1]
    out = torch.empty((pm, pn), dtype=plain.accumulator_dtype(x.dtype),
                      device=x.device)
    lib = _lib()
    code = lib.matmul_launch_capped(
        int(accumulate), _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), pm, pn, pk, bm, bn, bk, int(order == "nmk"),
        max_cluster, torch.cuda.current_stream(x.device).cuda_stream)
    name = "_acc_kernel" if accumulate else "_noacc_kernel"
    _build.check(lib, name, code)
    launches[name] += 1
    return out
