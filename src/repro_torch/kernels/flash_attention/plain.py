"""Plain PyTorch version of the flash-attention kernel.

It runs the Pallas grid's per-block loop (``_fa_kernel`` with
``interpret=True`` in the JAX package), statement for statement: for each
q block, the KV blocks in order, each skipped when the causal predicate
``jk * bkv <= iq * bq + bq - 1 + offset`` says it lies wholly above the
diagonal, else the f32 online-softmax update ``m_new -> p -> alpha -> l_new
-> acc`` with the padded KV tail and (causal) the bottom-right-aligned
upper triangle masked to ``NEG_INF``. The output is ``acc / l`` with ``l ==
0`` read as 1, in ``q.dtype``. The grid's head axis runs as a batch
dimension: every (head, q block) pair keeps its own state, and the
arithmetic per element is the grid's.

A row with no visible key (causal, ``q_len > kv_len``) reproduces the
kernel, not the oracle: its scores are all ``NEG_INF``, ``m_new`` stays
``NEG_INF`` and ``p = exp(0) = 1`` on every column of every live block,
padded tail included (``ref.py`` averages the ``kv_len`` real rows instead).

The CPU path of the kernel wrapper and ``EmulateRunner`` use it; on the
card only ``chip_smoke.py`` and the card tests run it, to hold the CUDA
kernel against it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bq: int, bkv: int, group: int, kv_len: int,
                          q_len: int, d_real: int,
                          causal: bool) -> torch.Tensor:
    """q (BH, pq, pd); k, v (BH // group, pkv, pd) -> (BH, pq, pd)."""
    bh, pq, pd = q.shape
    pkv = k.shape[1]
    scale = 1.0 / math.sqrt(d_real)
    offset = kv_len - q_len
    kv_head = torch.arange(bh, device=q.device) // group
    kh, vh = k.float()[kv_head], v.float()[kv_head]
    out = torch.empty_like(q)
    for iq in range(pq // bq):
        qb = q[:, iq * bq:(iq + 1) * bq].float()
        acc = torch.zeros((bh, bq, pd), dtype=torch.float32, device=q.device)
        m = torch.full((bh, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, bq, 1), dtype=torch.float32, device=q.device)
        rows = (iq * bq + offset
                + torch.arange(bq, device=q.device)[:, None])
        for jk in range(pkv // bkv):
            if causal and not jk * bkv <= iq * bq + bq - 1 + offset:
                continue
            kb = kh[:, jk * bkv:(jk + 1) * bkv]
            vb = vh[:, jk * bkv:(jk + 1) * bkv]
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            cols = jk * bkv + torch.arange(bkv, device=q.device)[None, :]
            mask = cols < kv_len
            if causal:
                mask = mask & (cols <= rows)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, iq * bq:(iq + 1) * bq] = (acc / l).to(q.dtype)
    return out
