"""Plain PyTorch version of the decode-attention kernel
(``csrc/decode_attention.cu``).

It runs the kernel's split arithmetic: the visible positions ``lo..hi``
(``hi = min(pos, T - 1)``; ``lo = 0``, or ``pos - window + 1`` where
``window >= 0``) cut into ``splits`` runs of ``ceil(n / splits)`` rounded up
to ``ALIGN``; in each run the f32 scores of each query head against its KV
head times ``1/sqrt(D)``, their max ``m``, ``p = exp(s - m)``, ``l = sum
p`` and ``acc = sum p.to(v.dtype) * v`` in f32; then the runs merged in
order, each weighted by ``exp(m - M)`` for the largest ``M``, and ``acc /
l`` cast to q's dtype. It differs from ``layers._sdpa`` at one query a row
only where a run's probabilities are rounded to v's dtype against the run's
own max instead of the row's (one rounding of each probability either
way), and in the order of f32 sums.

Only the tests and ``chip_smoke.py`` run it: on the CPU against
``layers._sdpa`` and the JAX package's ``_sdpa``, on the card to hold the
kernel against it.
"""

from __future__ import annotations

import math

import torch

ALIGN = 16  # a run's length is a multiple of this (the kernel's DA_ALIGN)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def visible(pos: int, t: int, window: int) -> tuple[int, int]:
    """The first and last position a query at ``pos`` sees in a cache of
    ``t`` slots."""
    lo = max(0, pos - window + 1) if window >= 0 else 0
    return lo, min(pos, t - 1)


def split_runs(pos: int, t: int, window: int,
               splits: int) -> list[tuple[int, int]]:
    """Each split's [start, stop) of the visible positions, empty ones
    included (start >= stop)."""
    lo, hi = visible(pos, t, window)
    chunk = _ceil_div(_ceil_div(hi - lo + 1, splits), ALIGN) * ALIGN
    return [(lo + s * chunk, min(lo + (s + 1) * chunk, hi + 1))
            for s in range(splits)]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos, window: int, splits: int) -> torch.Tensor:
    """q (B, 1, Hq, D); k, v (B, T, Hkv, D); ``pos`` an int or a 0-dim
    tensor -> (B, 1, Hq * D) in q's dtype."""
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, group, d)
    f32 = dict(dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for start, stop in split_runs(int(pos), t, window, splits):
        if start >= stop:
            ms.append(torch.full((b, hkv, group, 1), -math.inf, **f32))
            ls.append(torch.zeros((b, hkv, group, 1), **f32))
            accs.append(torch.zeros((b, hkv, group, d), **f32))
            continue
        sc = torch.einsum("bhgd,bnhd->bhgn", qf,
                          k[:, start:stop].float()) * scale
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhgn,bnhd->bhgd", p.to(v.dtype).float(),
                                 v[:, start:stop].float()))
    top = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for m, ls_, acc_ in zip(ms, ls, accs):
        w = torch.exp(m - top)
        l = l + ls_ * w
        acc = acc + acc_ * w
    return (acc / l).reshape(b, 1, hq * d).to(q.dtype)
