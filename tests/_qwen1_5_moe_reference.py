"""A plain reference of Qwen1.5-MoE-A2.7B's forward pass (the repo's copy;
the benchmark keeps its own in ``portbench/reference/qwen_moe_decode.py``).

Plain PyTorch in float32 with TF32 off, importing nothing of the JAX package
or of the port, written from the published description: the Hugging Face
``config.json`` of Qwen/Qwen1.5-MoE-A2.7B (``Qwen2MoeForCausalLM``) and
transformers' ``Qwen2MoeSparseMoeBlock``. Each layer: RMSNorm; q, k and v
projections with bias, o without; RoPE by rotate-half; causal softmax
attention, query head h reading KV head h // (H / KV); RMSNorm; a router
softmaxed over every expert's logit, whose top-k weights are kept as they
are unless ``norm_topk_prob``; each token run through its k experts'
SwiGLU, no capacity; one shared SwiGLU expert scaled by ``sigmoid(x @
w_shared_gate)``. Then the final RMSNorm and the untied head.

No cache and no batching tricks: every position of every row is computed
from the tokens alone. Departures, none of which changes the mathematics:
an expert runs on the rows that chose it (the published block's own loop
over experts), and RoPE's angles are computed in float64.

The weights are a nested dict, the layers stacked on a leading axis, each
projection stored (in, out) so that ``y = x @ w``, under the names of
``portbench/reference/qwen_moe_decode.py``'s docstring.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """Rotate-half RoPE of x (B, L, H, hd) at positions 0 .. L-1."""
    n, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q, k, v):
    b, n, h, hd = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(n, n, dtype=torch.bool).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, h * hd)


def _moe(t, lw, model):
    probs = torch.softmax(t @ lw["router"], dim=-1)              # (T, E)
    weight, chosen = torch.topk(probs, model["num_experts_per_tok"], dim=-1)
    if model["norm_topk_prob"]:
        weight = weight / weight.sum(-1, keepdim=True)
    y = torch.zeros_like(t)
    ex = lw["experts"]
    for e in range(model["num_experts"]):
        tok, slot = torch.where(chosen == e)
        if tok.numel():
            te = t[tok]
            act = F.silu(te @ ex["w_gate"][e]) * (te @ ex["w_up"][e])
            y.index_add_(0, tok, (act @ ex["w_down"][e])
                         * weight[tok, slot, None])
    sh = lw["shared"]
    shared = (F.silu(t @ sh["w_gate"]) * (t @ sh["w_up"])) @ sh["w_down"]
    return y + torch.sigmoid(t @ lw["shared_gate"]) * shared


def _layer(x, lw, model):
    b, n, d = x.shape
    h, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    eps = model["rms_norm_eps"]
    a = lw["attn"]
    t = _rms(x, lw["ln1"], eps)
    q = _rope((t @ a["wq"] + a["bq"]).view(b, n, h, hd), model["rope_theta"])
    k = _rope((t @ a["wk"] + a["bk"]).view(b, n, kv, hd), model["rope_theta"])
    v = (t @ a["wv"] + a["bv"]).view(b, n, kv, hd)
    x = x + _attention(q, k, v) @ a["wo"]
    t = _rms(x, lw["ln2"], eps).reshape(b * n, d)
    return x + _moe(t, lw, model).view(b, n, d)


def _layer_weights(tree, i):
    return {name: _layer_weights(v, i) if isinstance(v, dict)
            else v[i].float() for name, v in tree.items()}


def forward(model: dict, w: dict, tokens) -> torch.Tensor:
    """Logits (B, L, V) in float32 of every position of ``tokens`` (B, L),
    ``model`` the published config.json's keys."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens = torch.as_tensor(tokens).long()
    with torch.no_grad():
        x = w["embedding"][tokens].float()
        for i in range(model["num_hidden_layers"]):
            x = _layer(x, _layer_weights(w["layers"], i), model)
        x = _rms(x, w["final_norm"].float(), model["rms_norm_eps"])
        return x @ w["lm_head"].float()
