"""Wrapper of the CUDA latent decode-attention kernel
(``csrc/mla_decode.cu``).

``mla_decode`` is the absorbed form of latent attention (MLA) for one query
a row: ``models/mla.py``'s :func:`~repro_torch.models.mla.absorbed`, over
the bf16 latent rows as cached, reading only the visible positions. It
replaces no kernel of the JAX package, which has no latent attention. It
takes CUDA tensors only: it launches the kernel and its merge of the splits
on the current stream (span ``mla_decode.launch``), never waits for the
card and never reads a position held on the card, so a step captured as a
CUDA graph may call it; it counts the call (counter ``launch._mla_decode``,
:mod:`repro_torch.tracing`). ``plain.py`` is the same arithmetic in
PyTorch, which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

HEADS = 16   # query heads: the M = 16 of the tensor cores' tile
LAT = 512    # c_kv, the part of a row the output sums
ROPE = 64    # k_pe
WIDTH = LAT + ROPE
TILE = 64    # positions a block stages at once (the kernel's TILE)


def _lib() -> ctypes.CDLL:
    lib = _build.library("mla_decode")
    if lib.mla_decode_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.mla_decode_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                          ctypes.c_float, p]
        lib.mla_decode_launch.restype = ctypes.c_int
    return lib


def takes(heads: int, width: int) -> bool:
    """Whether the kernel computes ``heads`` heads over rows of ``width``:
    the widths it was built for, :data:`HEADS` and :data:`WIDTH`."""
    return heads == HEADS and width == WIDTH


def splits_for(b: int, t: int, sms: int) -> int:
    """The number of splits of the visible positions, from the shapes and
    the card's SM count alone: one block an SM (a block holds two staged
    tiles, ~168 KB of shared memory), at least one, and no split shorter
    than a tile of a full cache."""
    return max(1, min(sms // b, -(-t // TILE)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operands(q: torch.Tensor, cache: torch.Tensor, pos) -> None:
    """Raise unless ``q (B, 1, HEADS, WIDTH)`` and ``cache (B, T, WIDTH)``
    are contiguous bf16 tensors on one CUDA device, starting on 16 bytes,
    and ``pos`` (an int, or a 0-dim int32 tensor on their device) is a
    position 0 or later. The device is checked last, so each other refusal
    shows on CPU tensors too."""
    if q.dim() != 4 or cache.dim() != 3 or q.shape[1] != 1 \
            or q.shape[0] != cache.shape[0] or cache.shape[1] < 1 \
            or not takes(q.shape[2], q.shape[3]) \
            or cache.shape[2] != WIDTH:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(cache.shape)}: q (B, 1, {HEADS}, {WIDTH}) "
                         f"and a cache (B, T, {WIDTH})")
    if q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16:
        raise ValueError(f"unsupported dtypes {q.dtype}, {cache.dtype}: "
                         f"bf16")
    if not (q.is_contiguous() and cache.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if q.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError("operands must start on 16 bytes")
    if torch.is_tensor(pos):
        if pos.dim() != 0 or pos.dtype != torch.int32 \
                or pos.device != q.device:
            raise ValueError(f"a position tensor must be a 0-dim int32 on "
                             f"{q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
    elif pos < 0:
        raise ValueError(f"position {pos} sees no slot")
    if q.device != cache.device or q.device.type != "cuda":
        raise ValueError(f"operands on {q.device}, {cache.device}: the "
                         f"kernel takes one CUDA device")


def mla_decode(q: torch.Tensor, cache: torch.Tensor, pos,
               scale: float) -> torch.Tensor:
    """Attention of one query a row in the absorbed form: each of the 16
    heads' ``q (B, 1, 16, 576)`` (q_lat ‖ q_pe) against the latent rows
    ``cache (B, T, 576)`` (c_kv ‖ k_pe) at positions ``0..min(pos, T -
    1)``, scores times ``scale``, the output the probabilities' sum of each
    row's c_kv. Returns ``(B, 1, 16, 512)`` in bf16. A position held on the
    card (a 0-dim int32 tensor) is the caller's to keep at 0 or later."""
    check_operands(q, cache, pos)
    b, t = cache.shape[:2]
    splits = splits_for(b, t, _sm_count(q.device.index))
    out = torch.empty((b, 1, HEADS, LAT), dtype=q.dtype, device=q.device)
    part = torch.empty(b * splits * HEADS * (LAT + 2), dtype=torch.float32,
                       device=q.device)
    on_card = torch.is_tensor(pos)
    lib = _lib()
    with tracing.span("mla_decode.launch"):
        code = lib.mla_decode_launch(
            q.data_ptr(), cache.data_ptr(), out.data_ptr(), part.data_ptr(),
            pos.data_ptr() if on_card else None, 0 if on_card else int(pos),
            b, t, splits, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "_mla_decode", code)
    tracing.count("launch._mla_decode")
    return out
