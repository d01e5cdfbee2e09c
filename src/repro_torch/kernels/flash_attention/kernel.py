"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_blocked`` is the port of ``_fa_kernel`` of the JAX
package's ``kernels/flash_attention/kernel.py``. On a CUDA tensor it
launches the kernel (span ``attention.launch``) and counts the launch
(counter ``launch._fa_kernel``, :mod:`repro_torch.tracing`); on a CPU
tensor it runs the plain version (``plain.py``), and only there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.core.space import KernelParams
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if lib.fa_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.fa_launch.argtypes = [i, p, p, p, p] + [i] * 11 + [p]
        lib.fa_launch.restype = ctypes.c_int
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   params: KernelParams) -> None:
    """Raise unless ``q (B*Hq, pq, pd)`` and ``k``, ``v (B*Hkv, pkv, pd)``
    are contiguous tensors of one supported dtype on one device, shaped as
    ``params.padded_dims`` says and tiled exactly by ``params.block``."""
    b, hq, hkv, pq, pkv, pd = params.padded_dims
    bq, bkv = params.block
    if tuple(q.shape) != (b * hq, pq, pd) or \
            tuple(k.shape) != (b * hkv, pkv, pd) or k.shape != v.shape:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for padded "
                         f"dims {params.padded_dims}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if hkv < 1 or hq % hkv or bq < 1 or bkv < 1 or pq % bq or pkv % bkv:
        raise ValueError(f"block {params.block} does not tile ({pq}, {pkv}) "
                         f"or heads {hq}/{hkv} do not group")


def plain_version(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  params: KernelParams) -> torch.Tensor:
    """The plain version (``plain.py``) of what the kernel computes for
    ``params``, on the operands' own device."""
    _b, hq, hkv = params.padded_dims[:3]
    q_len, kv_len, d_real = params.dims[3:6]
    return plain.flash_attention_plain(q, k, v, *params.block, hq // hkv,
                                       kv_len, q_len, d_real,
                                       params.order == "qk_causal")


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            params: KernelParams) -> torch.Tensor:
    """Padded blockwise attention with the schedule's (bq, bkv) block:
    ``(B*Hq, pq, pd)`` out, in ``q.dtype``. The true lengths and head dim
    (masking and scale) are ``params.dims[3:6]``; ``params.order ==
    "qk_causal"`` selects the bottom-right-aligned causal mask."""
    check_operands(q, k, v, params)
    if q.device.type == "cpu":
        return plain_version(q, k, v, params)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, hq, hkv, pq, pkv, pd = params.padded_dims
    q_len, kv_len, d_real = params.dims[3:6]
    bq, bkv = params.block
    out = torch.empty_like(q)
    lib = _lib()
    with tracing.span("attention.launch"):
        code = lib.fa_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b * hq, hq // hkv, pq, pkv, pd, bq, bkv, kv_len,
            q_len, d_real, int(params.order == "qk_causal"),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "_fa_kernel", code)
    tracing.count("launch._fa_kernel")
    return out
