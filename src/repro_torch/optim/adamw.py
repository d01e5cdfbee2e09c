"""AdamW with cosine schedule (the JAX package's ``optim/adamw.py``,
ported).

Optimizer state mirrors the parameter tree leaf for leaf under the same
names (``{"m": tree, "v": tree, "step": int32 tensor}``), so the port's
``CheckpointManager`` writes it in the reference's layout.

The arithmetic is the reference's, in its order: clip by the global norm,
the moments, the bias corrections, then ``p - lr * (mhat / (sqrt(vhat) +
eps) + wd * p)`` (``torch.optim.AdamW`` orders the decay and epsilon
otherwise). Unlike the reference, :func:`update` writes the new parameters
and moments into the given tensors in place and returns them: a model of
2.5 B f32 parameters cannot hold a second copy of its weights and moments
beside the first on one 80 GB card. The schedule, the bias corrections and
the clip factor stay tensors on the parameters' device, so a step never
waits for the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.optim.tree import leaves, param_tree, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a tensor) as an f32
    tensor: linear warmup, then cosine decay to ``min_lr_ratio``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params) -> dict[str, Any]:
    """Zero moments mirroring ``params`` (a module or a tree) and step 0."""
    tree = param_tree(params)
    device = leaves(tree)[0].device
    zeros = lambda: tree_map(torch.zeros_like, tree)
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _norm(tensors) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tensors])))


def global_norm(tree) -> torch.Tensor:
    return _norm(leaves(tree))


def _laid_out_as(g, p):
    """The gradient ``g`` laid out as its parameter ``p`` is: a DTensor
    gradient in other placements (a pending sum among them) is
    redistributed to ``p``'s, so the clip's norm reduces over every shard
    and the update stays local."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics); the new
    parameters and moments are ``params``' and ``state``'s tensors, written
    in place. DTensor leaves work as plain ones, each gradient laid out as
    its parameter first."""
    step = state["step"]
    grads = [_laid_out_as(g, p)
             for g, p in zip(leaves(grads), leaves(params), strict=True)]
    gnorm = _norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    lr = schedule(cfg, step)
    # One leaf at a time, in place where the reference's order allows:
    # each op is a pass over a leaf-sized tensor (the step is bound by
    # memory), and the temporaries stay one leaf's.
    for p, g, m, v in zip(leaves(params), grads,
                          leaves(state["m"]), leaves(state["v"]),
                          strict=True):
        g = g * clip
        m.mul_(b1).add_(g, alpha=1 - b1)            # b1 m + (1 - b1) g
        v.mul_(b2).addcmul_(g, g, value=1 - b2)     # b2 v + (1 - b2) g^2
        del g
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:  # + 0 * p adds nothing to a finite p
            upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd.mul_(lr).to(p.dtype))             # p - lr * (...)
    new_state = {"m": state["m"], "v": state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
