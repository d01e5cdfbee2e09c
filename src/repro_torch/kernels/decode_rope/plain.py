"""Plain PyTorch version of the decode-step attention prologue
(``csrc/decode_rope.cu``), in its two modes.

It runs the eager path's arithmetic op for op: ``models/layers.py``'s bias
adds, ``apply_rope`` (halves) and cache write for a GQA layer;
``models/mla.py``'s ``kv_norm``, ``rope`` (interleaved pairs), latent row
and query (q_lat ‖ q_pe) for a latent one. The frequencies are the f32 of
the float64 ``1 / theta^(2i / d)``, the angles ``f32(pos) * freq``, every
product and sum in f32, one cast back. On the CPU it gives the eager path's
bits.

Only the tests and ``chip_smoke.py`` run it: on the CPU against the eager
functions, on the card to hold the kernel against it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_norm.plain import decode_norm_plain


def freqs(d: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies of width ``d``, (d/2,) f32, computed in
    float64 on ``device``."""
    exps = torch.arange(0, d, 2, dtype=torch.float64, device=device) / d
    return (1.0 / torch.pow(theta, exps)).float()


def angles(pos, b: int, d: int, theta: float, device) -> torch.Tensor:
    """Each row's angles at ``pos`` (an int or a 0-dim int32 tensor), (b,
    1, d/2) f32."""
    positions = (pos.expand(b, 1) if torch.is_tensor(pos) else
                 torch.full((b, 1), pos, dtype=torch.int32, device=device))
    return positions[..., None].float() * freqs(d, theta, device)


def rotate_halves(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (b, 1, H, D): dim i with dim i + D/2, by ``a`` (b, 1, D/2)."""
    cos, sin = torch.cos(a)[..., None, :], torch.sin(a)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rotate_pairs(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (b, 1, H, d): dim 2i with dim 2i + 1, by ``a`` (b, 1, d/2)."""
    d = x.shape[-1]
    cos, sin = torch.cos(a)[..., None, :], torch.sin(a)[..., None, :]
    xf = x.float().unflatten(-1, (d // 2, 2))
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


def _slot(pos, t: int) -> int:
    return min(int(pos), t - 1)


def decode_rope_plain(q, k, v, k_cache, v_cache, pos, theta: float,
                      bias=None) -> torch.Tensor:
    """GQA: the projections ``q (B, 1, Hq * D)``, ``k``, ``v (B, 1, Hkv *
    D)`` plus ``bias`` (bq, bk, bv) where given; k rotated and v written
    into ``k_cache``, ``v_cache (B, T, Hkv, D)`` at ``min(pos, T - 1)``.
    Returns q rotated, (B, 1, Hq, D)."""
    b = q.shape[0]
    t, d = k_cache.shape[1], k_cache.shape[3]
    if bias is not None:
        q, k, v = (y + w for y, w in zip((q, k, v), bias))
    q, k, v = (y.reshape(b, 1, -1, d) for y in (q, k, v))
    a = angles(pos, b, d, theta, q.device)
    q, k = rotate_halves(q, a), rotate_halves(k, a)
    slot = _slot(pos, t)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    return q


def decode_rope_mla_plain(q, kv, norm, q_lat, cache, pos, theta: float,
                          nope: int, eps: float) -> torch.Tensor:
    """MLA: ``q (B, 1, H * (nope + rope))`` and ``kv (B, 1, r + rope)``
    (``x @ wq``, ``x @ wkv_a``); the latent row, c_kv RMS-normed by
    ``norm (r,)`` ‖ k_pe rotated, written into ``cache (B, T, r + rope)``
    at ``min(pos, T - 1)``. Returns each head's ``q_lat (B, H, r)`` ‖ q_pe
    rotated, (B, 1, H, r + rope)."""
    b, h, r = q_lat.shape
    rope = kv.shape[-1] - r
    a = angles(pos, b, rope, theta, q.device)
    c_kv = decode_norm_plain(kv[..., :r], None, norm, eps)[1]
    k_pe = rotate_pairs(kv[..., None, r:], a)[..., 0, :]
    cache[:, _slot(pos, cache.shape[1])] = torch.cat(
        [c_kv, k_pe], dim=-1)[:, 0].to(cache.dtype)
    q_pe = rotate_pairs(q.view(b, 1, h, -1)[..., nope:], a)
    return torch.cat([q_lat[:, None], q_pe], dim=-1)
