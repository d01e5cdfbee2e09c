"""Wrapper of the CUDA decode-step norm kernel (``csrc/decode_norm.cu``).

``decode_norm`` is a residual add and the RMSNorm after it, what
``models/layers.py``'s ``x + y`` and ``rms_norm`` compute, in one launch. It
replaces no kernel of the JAX package, which leaves the norm to XLA; it
replaces a chain of ten eager launches. It takes CUDA tensors only: it
launches on the current stream (span ``decode_norm.launch``), never waits
for the card and allocates only its outputs, so a step captured as a CUDA
graph may call it; it counts the call (counter ``launch._decode_norm``,
:mod:`repro_torch.tracing`). ``plain.py`` is the same arithmetic in
PyTorch, which the tests hold it against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import _build

VEC = 8           # D a multiple of this: 16-byte loads of bf16
MAX_WIDTH = 8192  # D: 256 lanes of four 16-byte chunks


def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_norm")
    if lib.decode_norm_launch.argtypes is None:
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.decode_norm_launch.argtypes = [p, p, p, p, p, i, i, f, f, p]
        lib.decode_norm_launch.restype = ctypes.c_int
    return lib


def takes(d: int) -> bool:
    """Whether the kernel normalises rows of width ``d``: a multiple of
    :data:`VEC` up to :data:`MAX_WIDTH`."""
    return d % VEC == 0 and 0 < d <= MAX_WIDTH


def mean_factor(rows: int, d: int) -> float:
    """The factor PyTorch's mean over the last dim of ``rows`` rows of
    ``d`` multiplies the sum by: outputs over elements, divided in f32."""
    return float(np.float32(rows) / np.float32(rows * d))


def check_operands(x: torch.Tensor, y: torch.Tensor | None,
                   scale: torch.Tensor) -> None:
    """Raise unless ``x (..., D)``, ``y`` (x's shape, or None) and ``scale
    (D,)`` are contiguous bf16 tensors on one CUDA device, starting on 16
    bytes, with ``D`` one :func:`takes` takes. The device is checked last,
    so each other refusal shows on CPU tensors too."""
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or x.numel() == 0 or scale.shape != (d,) or (
            y is not None and y.shape != x.shape):
        raise ValueError(f"bad operand shapes {tuple(x.shape)}, "
                         f"{None if y is None else tuple(y.shape)}, "
                         f"{tuple(scale.shape)}")
    if not takes(d):
        raise ValueError(f"width {d}: the kernel takes multiples of {VEC} "
                         f"up to {MAX_WIDTH}")
    tensors = [x, scale] + ([] if y is None else [y])
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"unsupported dtypes "
                         f"{[str(t.dtype) for t in tensors]}: bf16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("operands must start on 16 bytes")
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}: "
                         f"the kernel takes one CUDA device")


def decode_norm(x: torch.Tensor, y: torch.Tensor | None,
                scale: torch.Tensor, eps: float):
    """``(s, rms_norm(s))`` with ``s = x + y`` rounded to bf16 (``s = x``
    where ``y`` is None, and then ``x`` itself is returned): the new
    residual stream and its norm, both in x's shape."""
    check_operands(x, y, scale)
    d = x.shape[-1]
    rows = x.numel() // d
    s = x if y is None else torch.empty_like(x)
    out = torch.empty_like(x)
    lib = _lib()
    with tracing.span("decode_norm.launch"):
        code = lib.decode_norm_launch(
            x.data_ptr(), None if y is None else y.data_ptr(),
            scale.data_ptr(), None if y is None else s.data_ptr(),
            out.data_ptr(), rows, d, mean_factor(rows, d), eps,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, "_decode_norm", code)
    tracing.count("launch._decode_norm")
    return s, out
