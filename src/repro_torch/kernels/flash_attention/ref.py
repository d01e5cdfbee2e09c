"""Plain PyTorch oracle for blockwise attention (the JAX package's ref.py):
GQA, optional bottom-right-aligned causal mask."""

import math

import torch


def attention_ref(q, k, v, causal: bool = True):
    """q (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D)."""
    _b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) \
        / math.sqrt(float(d))
    if causal:
        mask = torch.tril(torch.ones((lq, lkv), dtype=torch.bool,
                                     device=q.device), diagonal=lkv - lq)
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
