"""Plain PyTorch version of the latent decode-attention kernel
(``csrc/mla_decode.cu``).

It runs the kernel's arithmetic: the visible positions 0..hi (``hi =
min(pos, T - 1)``) cut into ``splits`` runs of ``ceil((hi + 1) / splits)``
rounded up to ``TILE``; each run taken ``TILE`` positions at a time, as the
kernel stages them: the f32 scores of every head, ``q · row * scale`` over
the row's whole width (q_lat against c_kv, q_pe against k_pe), the running
max ``m`` raised to the tile's, ``p = exp(s - m)`` rounded to bf16 for the
product with the rows' first ``LAT`` dims (c_kv), the running sum ``l`` of
the unrounded ``p`` and the running output, both scaled by ``exp(m_old -
m)``; then the runs merged in order, each weighted by ``exp(m - M)`` for
the largest ``M``, and ``acc / l`` cast to q's dtype. It differs from
``models/mla.py``'s :func:`absorbed` only where a tile's probabilities are
rounded against the running max instead of the row's (one rounding of each
either way), and in the order of f32 sums.

Only the tests and ``chip_smoke.py`` run it: on the CPU against
``absorbed``, on the card to hold the kernel against it.
"""

from __future__ import annotations

import math

import torch

TILE = 64   # positions a block stages at once; a run's length a multiple


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split_runs(pos: int, t: int, splits: int) -> list[tuple[int, int]]:
    """Each split's [start, stop) of the visible positions, empty ones
    included (start >= stop)."""
    hi = min(pos, t - 1)
    chunk = _ceil_div(_ceil_div(hi + 1, splits), TILE) * TILE
    return [(s * chunk, min((s + 1) * chunk, hi + 1)) for s in range(splits)]


def mla_decode_plain(q: torch.Tensor, cache: torch.Tensor, pos, scale: float,
                     splits: int, lat: int = 512) -> torch.Tensor:
    """q (B, 1, H, W); cache (B, T, W); ``pos`` an int or a 0-dim tensor ->
    (B, 1, H, lat) in q's dtype."""
    b, _, h, _ = q.shape
    t = cache.shape[1]
    qf = q[:, 0].float()
    f32 = dict(dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for start, stop in split_runs(int(pos), t, splits):
        m = torch.full((b, h, 1), -math.inf, **f32)
        l = torch.zeros((b, h, 1), **f32)
        acc = torch.zeros((b, h, lat), **f32)
        for t0 in range(start, stop, TILE):
            rows = cache[:, t0:min(t0 + TILE, stop)].float()
            sc = torch.einsum("bhw,bnw->bhn", qf, rows) * scale
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhn,bnc->bhc", p.to(torch.bfloat16).float(), rows[..., :lat])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    top = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for m, ls_, acc_ in zip(ms, ls, accs):
        w = torch.exp(m - top)
        l = l + ls_ * w
        acc = acc + acc_ * w
    return (acc / l)[:, None].to(q.dtype)
