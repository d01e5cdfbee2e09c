"""Wrapper of the CUDA decode-step attention prologue
(``csrc/decode_rope.cu``).

``decode_rope`` (GQA) and ``decode_rope_mla`` (latent attention) take a
decode step's projections to the query attention reads and the cache row
it reads beside the others: the biases, RoPE (halves or interleaved
pairs), the latent row's norm and the cache write, in one launch. They
replace no kernel of the JAX package, which leaves this to XLA; they
replace a chain of eager launches of ``models/layers.py`` and
``models/mla.py``. They take CUDA tensors only: each launches on the
current stream (span ``decode_rope.launch``), never waits for the card,
never reads a position held on the card and allocates only its output, so
a step captured as a CUDA graph may call it; each counts the call (counter
``launch._decode_rope``, :mod:`repro_torch.tracing`). ``plain.py`` is the
same arithmetic in PyTorch, which the tests hold them against.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.decode_norm.kernel import mean_factor

MAX_HEAD_DIM = 512  # GQA: a head's pairs over a block's lanes
MAX_LATENT = 1024   # MLA: c_kv held in registers, 8 a lane of 128
MAX_ROPE = 256


def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_rope")
    if lib.decode_rope_gqa_launch.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        f, dbl = ctypes.c_float, ctypes.c_double
        lib.decode_rope_gqa_launch.argtypes = \
            [p, p, p, ll, ll, ll, p, p, p, p, p, p] + [ll] * 6 \
            + [p, i, i, i, i, i, i, dbl, p]
        lib.decode_rope_gqa_launch.restype = ctypes.c_int
        lib.decode_rope_mla_launch.argtypes = \
            [p, ll, p, ll, p, p, ll, ll, p, p, ll, ll, p] + [i] * 7 \
            + [f, f, dbl, p]
        lib.decode_rope_mla_launch.restype = ctypes.c_int
    return lib


def takes(head_dim: int) -> bool:
    """Whether the GQA mode rotates heads of ``head_dim``: even, up to
    :data:`MAX_HEAD_DIM`."""
    return head_dim % 2 == 0 and 0 < head_dim <= MAX_HEAD_DIM


def takes_mla(r: int, rope: int) -> bool:
    """Whether the MLA mode takes latent rows of ``r`` + ``rope``: ``r`` up
    to :data:`MAX_LATENT`, ``rope`` even up to :data:`MAX_ROPE`."""
    return 0 < r <= MAX_LATENT and rope % 2 == 0 and 0 < rope <= MAX_ROPE


def _check_position(pos, device) -> None:
    if torch.is_tensor(pos):
        if pos.dim() != 0 or pos.dtype != torch.int32 \
                or pos.device != device:
            raise ValueError(f"a position tensor must be a 0-dim int32 on "
                             f"{device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
    elif not 0 <= pos < 2**31:
        raise ValueError(f"position {pos} out of range")


def _check_common(tensors: list, pos) -> None:
    """bf16, a unit stride along the last dim, the position, and one CUDA
    device, checked last."""
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"unsupported dtypes "
                         f"{[str(t.dtype) for t in tensors]}: bf16")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("operands need a unit stride along their last dim")
    _check_position(pos, tensors[0].device)
    if any(t.device != tensors[0].device for t in tensors) \
            or tensors[0].device.type != "cuda":
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}: "
                         f"the kernel takes one CUDA device")


def _pos_args(pos) -> tuple:
    on_card = torch.is_tensor(pos)
    return (pos.data_ptr() if on_card else None, 0 if on_card else int(pos))


def check_operands(q, k, v, k_cache, v_cache, pos, bias=None) -> None:
    """Raise unless ``q (B, 1, Hq * D)``, ``k``, ``v (B, 1, Hkv * D)``, the
    caches ``(B, T, Hkv, D)`` and ``bias`` (bq, bk, bv of Hq * D, Hkv * D,
    Hkv * D, or None) are bf16 tensors with a unit stride along their last
    dim on one CUDA device, ``D`` one :func:`takes` takes and Hq a multiple
    of Hkv, and ``pos`` an int from 0 or a 0-dim int32 tensor on their
    device. The device is checked last."""
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, t, hkv, d = k_cache.shape
    if not takes(d):
        raise ValueError(f"head dim {d}: the kernel takes even ones up to "
                         f"{MAX_HEAD_DIM}")
    kv = (b, 1, hkv * d)
    if q.shape[0] != b or q.shape[2] % d or q.shape[2] // d % hkv \
            or k.shape != kv or v.shape != kv:
        raise ValueError(f"bad projection shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for a cache "
                         f"{tuple(k_cache.shape)}")
    tensors = [q, k, v, k_cache, v_cache]
    if bias is not None:
        if tuple(w.shape for w in bias) != ((q.shape[2],), (hkv * d,),
                                            (hkv * d,)):
            raise ValueError(f"bad bias shapes "
                             f"{[tuple(w.shape) for w in bias]}")
        tensors += list(bias)
    _check_common(tensors, pos)


def decode_rope(q, k, v, k_cache, v_cache, pos, theta: float,
                bias=None) -> torch.Tensor:
    """GQA: the projections plus ``bias`` where given, q and k rotated by
    halves at ``pos``, k and v written into the caches at ``min(pos, T -
    1)``. Returns q rotated, (B, 1, Hq, D) in bf16. A position held on the
    card is the caller's to keep at 0 or later."""
    check_operands(q, k, v, k_cache, v_cache, pos, bias)
    b, t, hkv, d = k_cache.shape
    hq = q.shape[2] // d
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    bq, bk, bv = (None,) * 3 if bias is None else \
        (w.data_ptr() for w in bias)
    lib = _lib()
    with tracing.span("decode_rope.launch"):
        code = lib.decode_rope_gqa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
            k.stride(0), v.stride(0), bq, bk, bv, out.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), *k_cache.stride()[:3],
            *v_cache.stride()[:3], *_pos_args(pos), b, t, hq, hkv, d,
            float(theta), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "_decode_rope", code)
    tracing.count("launch._decode_rope")
    return out


def check_operands_mla(q, kv, norm, q_lat, cache, pos, nope: int) -> None:
    """Raise unless ``q (B, 1, H * (nope + rope))``, ``kv (B, 1, r +
    rope)``, ``norm (r,)``, ``q_lat (B, H, r)`` and ``cache (B, T, r +
    rope)`` are bf16 tensors with a unit stride along their last dim on one
    CUDA device, ``r`` and ``rope`` ones :func:`takes_mla` takes, and
    ``pos`` an int from 0 or a 0-dim int32 tensor on their device. The
    device is checked last."""
    if q_lat.dim() != 3 or cache.dim() != 3 or q.dim() != 3 \
            or kv.dim() != 3 or norm.dim() != 1:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(kv.shape)}, {tuple(q_lat.shape)}, "
                         f"{tuple(cache.shape)}")
    b, h, r = q_lat.shape
    rope = cache.shape[2] - r
    if not takes_mla(r, rope):
        raise ValueError(f"latent rows of {r} + {rope}: the kernel takes "
                         f"up to {MAX_LATENT} + an even rope up to "
                         f"{MAX_ROPE}")
    if q.shape != (b, 1, h * (nope + rope)) or kv.shape != (b, 1, r + rope) \
            or norm.shape != (r,) or cache.shape[0] != b or nope < 0:
        raise ValueError(f"bad operand shapes {tuple(q.shape)}, "
                         f"{tuple(kv.shape)}, {tuple(norm.shape)} for "
                         f"{h} heads of {nope} + {rope} and rows of {r} + "
                         f"{rope}")
    _check_common([q, kv, norm, q_lat, cache], pos)


def decode_rope_mla(q, kv, norm, q_lat, cache, pos, theta: float, nope: int,
                    eps: float) -> torch.Tensor:
    """MLA: the latent row (c_kv of ``kv`` RMS-normed by ``norm`` with
    ``eps`` ‖ k_pe rotated by pairs at ``pos``) written into ``cache`` at
    ``min(pos, T - 1)``. Returns each head's ``q_lat`` ‖ its q_pe (the last
    rope dims of its ``nope + rope`` in ``q``) rotated, (B, 1, H, r + rope)
    in bf16, the query the latent decode kernel reads."""
    check_operands_mla(q, kv, norm, q_lat, cache, pos, nope)
    b, h, r = q_lat.shape
    t, width = cache.shape[1:]
    out = torch.empty((b, 1, h, width), dtype=q.dtype, device=q.device)
    lib = _lib()
    with tracing.span("decode_rope.launch"):
        code = lib.decode_rope_mla_launch(
            q.data_ptr(), q.stride(0), kv.data_ptr(), kv.stride(0),
            norm.data_ptr(), q_lat.data_ptr(), q_lat.stride(0),
            q_lat.stride(1), out.data_ptr(), cache.data_ptr(),
            cache.stride(0), cache.stride(1), *_pos_args(pos), b, t, h, nope,
            r, width - r, mean_factor(b, r), eps, float(theta),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "_decode_rope", code)
    tracing.count("launch._decode_rope")
    return out
