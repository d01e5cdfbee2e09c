"""Plain PyTorch version of the decode-step MoE kernel
(``csrc/moe_decode.cu``).

It runs the kernel's arithmetic: the router's logits ``x @ W_r`` in f32,
rounded to x's dtype; each row's top-k by a stable descending sort (a tie
goes to the lower index), weighted by the softmax over every expert or, with
``norm_topk_prob``, by the softmax of the k chosen logits; the shared
expert's gate ``sigmoid`` of the rounded ``x @ w_s``. Or, in the sigmoid
mode (``scoring="sigmoid"``, DeepSeek-V3's routing): the logits in f32,
unrounded; each expert's score ``sigmoid(logit)``; the top-k by a stable
descending sort of score + bias; the weights the chosen unbiased scores,
with ``norm_topk_prob`` divided by their sum + 1e-20, times ``scale``. Then
each chosen expert's
``silu(x @ W_g) * (x @ W_u)`` and its product with ``W_d`` in f32, the
shared expert the same in parts of the routed experts' width; then each
row's routed results times their weights in top-k order, plus its shared
parts' sum times its gate, in f32, rounded to x's dtype once. It differs
from ``models/moe.py``'s grouped path only in keeping the products between
the projections in f32 where that path rounds each to x's dtype, and in the
order of f32 sums.

Only the tests and ``chip_smoke.py`` run it: on the CPU against the grouped
path, on the card to hold the kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Routing(NamedTuple):
    """A step's routing as the kernel's first launch leaves it."""
    logits: torch.Tensor       # (N, E) f32; softmax's rounded to x's dtype
    sel: torch.Tensor          # (N, K) int32: each row's experts, best first
    gates: torch.Tensor        # (N, K) f32: their weights
    shared_gate: torch.Tensor  # (N,) f32: the shared expert's weight
    counts: torch.Tensor       # (E,) int32: rows that chose each expert


def silu(g: torch.Tensor) -> torch.Tensor:
    return g / (1 + torch.exp(-g))


def route(x, router, shared_gate, top_k: int, norm_topk_prob: bool, *,
          scoring: str = "softmax", bias=None, scale: float = 1.0):
    """The routing of rows ``x`` (N, D): :class:`Routing`."""
    xf = x.float()
    if scoring == "sigmoid":
        logits = xf @ router.float()
        scores = torch.sigmoid(logits)
        choice = scores if bias is None else scores + bias.float()
        sel = torch.sort(choice, dim=-1, descending=True,
                         stable=True)[1][:, :top_k]
        gates = torch.gather(scores, -1, sel)
        if norm_topk_prob:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
        gates = gates * scale
    else:
        logits = (xf @ router.float()).to(x.dtype).float()
        vals, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, sel = vals[:, :top_k], sel[:, :top_k]
        if norm_topk_prob:
            gates = torch.softmax(vals, dim=-1)
        else:
            gates = torch.gather(torch.softmax(logits, dim=-1), -1, sel)
    if shared_gate is None:
        sg = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    else:
        sg = torch.sigmoid(
            (xf @ shared_gate.float()).to(x.dtype).float())[:, 0]
    counts = torch.bincount(sel.reshape(-1), minlength=router.shape[1])
    return Routing(logits, sel.to(torch.int32), gates, sg,
                   counts.to(torch.int32))


def _swiglu(xf, w_gate, w_up, w_down):
    return (silu(xf @ w_gate.float()) * (xf @ w_up.float())) @ w_down.float()


def moe_decode_plain(x, router, experts: dict, shared: dict | None,
                     shared_gate, top_k: int, norm_topk_prob: bool, *,
                     scoring: str = "softmax", bias=None, scale: float = 1.0,
                     sel=None):
    """x (N, D); router (D, E); ``experts`` w_gate, w_up (E, D, F) and
    w_down (E, F, D); ``shared`` w_gate, w_up (D, P * F) and w_down (P * F,
    D), or None; ``shared_gate`` (D, 1) or None; the routing mode as
    :func:`route` takes it; ``sel`` (N, K) int32, where the chosen experts
    are also written, or None -> (y (N, D) in x's dtype,
    :class:`Routing`)."""
    n, d = x.shape
    f = experts["w_gate"].shape[-1]
    xf = x.float()
    routing = route(x, router, shared_gate, top_k, norm_topk_prob,
                    scoring=scoring, bias=bias, scale=scale)
    if sel is not None:
        sel.copy_(routing.sel)
    outs = torch.empty((n, top_k, d), dtype=torch.float32, device=x.device)
    for e in torch.unique(routing.sel).tolist():
        rows, j = torch.where(routing.sel == e)
        outs[rows, j] = _swiglu(xf[rows], experts["w_gate"][e],
                                experts["w_up"][e], experts["w_down"][e])
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        y = y + routing.gates[:, j, None] * outs[:, j]
    if shared is not None:
        s = torch.zeros_like(y)
        for p0 in range(0, shared["w_gate"].shape[-1], f):
            cols = slice(p0, p0 + f)
            s = s + _swiglu(xf, shared["w_gate"][:, cols],
                            shared["w_up"][:, cols], shared["w_down"][cols])
        y = y + routing.shared_gate[:, None] * s
    return y.to(x.dtype), routing
