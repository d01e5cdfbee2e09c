"""Wrapper of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

``decode_attention`` is what ``layers._sdpa`` computes for one query a row
against a KV cache, reading only the cache's visible positions. It replaces
no kernel of the JAX package, which leaves decode attention to XLA's
einsums. It takes CUDA tensors only: it launches the kernel and its merge
of the splits on the current stream (span ``decode_attention.launch``),
never waits for the card and never reads a position held on the card, so a
step captured as a CUDA graph may call it; it counts the launch (counter
``launch._decode_attention``, :mod:`repro_torch.tracing`). ``plain.py`` is
the same arithmetic in PyTorch, which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import plain

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
MAX_GROUP = 8       # query heads a KV head: the kernel's register budget
MIN_SPLIT = 64      # positions a split takes at the least
SCORE_BYTES = 32768  # a split's f32 scores of its group, in shared memory


def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.decode_attention_launch.argtypes = \
            [i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def splits_for(b: int, hkv: int, t: int, group: int, sms: int) -> int:
    """The number of splits of the visible positions, from the shapes and
    the card's SM count alone: about four blocks an SM, no split under
    ``MIN_SPLIT`` of a full cache, and enough that a split's scores fit
    ``SCORE_BYTES``."""
    want = -(-4 * sms // (b * hkv))
    most = -(-t // MIN_SPLIT)
    least = -(-t * group * 4 // SCORE_BYTES)
    return max(min(want, most), least, 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                   window: int) -> None:
    """Raise unless ``q (B, 1, Hq, D)`` and ``k``, ``v (B, T, Hkv, D)`` are
    contiguous tensors of one supported dtype on one CUDA device, starting
    on 16 bytes, with ``D`` in :data:`HEAD_DIMS` and ``Hq / Hkv`` a whole
    number up to :data:`MAX_GROUP`, and ``pos`` (an int, or a 0-dim int32
    tensor on their device) leaves the query a visible position. The device
    is checked last, so each other refusal shows on CPU tensors too."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] != 1 \
            or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv or hq // hkv > MAX_GROUP or t < 1 or b < 1:
        raise ValueError(f"{hq} query heads over {hkv} KV heads, {t} slots")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("operands must start on 16 bytes")
    if window == 0:
        raise ValueError("a window of 0 leaves no visible position")
    if torch.is_tensor(pos):
        if pos.dim() != 0 or pos.dtype != torch.int32 \
                or pos.device != q.device:
            raise ValueError(f"a position tensor must be a 0-dim int32 on "
                             f"{q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
    else:
        lo, hi = plain.visible(pos, t, window)
        if pos < 0 or lo > hi:
            raise ValueError(f"position {pos} sees no slot of {t} "
                             f"(window {window})")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}: "
                         f"the kernel takes one CUDA device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                     window: int = -1) -> torch.Tensor:
    """Attention of one query a row: ``q (B, 1, Hq, D)`` against the cache
    ``k``, ``v (B, T, Hkv, D)`` at positions ``lo..min(pos, T - 1)`` (``lo =
    0``, or ``pos - window + 1`` where ``window >= 0``); query head h reads
    KV head ``h // (Hq / Hkv)``. Returns ``(B, 1, Hq * D)`` in q's dtype.
    A position held on the card (a 0-dim int32 tensor) is the caller's to
    keep in range: it must leave a visible position, as an int must."""
    check_operands(q, k, v, pos, window)
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    splits = splits_for(b, hkv, t, group, _sm_count(q.device.index))
    out = torch.empty((b, 1, hq * d), dtype=q.dtype, device=q.device)
    part = torch.empty(b * hkv * splits * group * (d + 2),
                       dtype=torch.float32, device=q.device)
    on_card = torch.is_tensor(pos)
    lib = _lib()
    with tracing.span("decode_attention.launch"):
        code = lib.decode_attention_launch(
            DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), part.data_ptr(),
            pos.data_ptr() if on_card else None, 0 if on_card else int(pos),
            b, t, hkv, group, window, splits,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "_decode_attention", code)
    tracing.count("launch._decode_attention")
    return out
