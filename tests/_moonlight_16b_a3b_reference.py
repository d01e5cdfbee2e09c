"""A plain reference of Moonlight-16B-A3B's forward pass (the repo's copy;
the benchmark keeps its own in ``portbench/reference/moonlight_decode.py``).

Plain PyTorch in float32 with TF32 off, importing nothing of the JAX package
or of the port, written from the published description: the Hugging Face
``config.json`` of moonshotai/Moonlight-16B-A3B (``model_type``
deepseek_v3) and the DeepSeek-V3 modelling code it names
(``DeepseekV3Attention``, ``DeepseekV3MoE``, ``MoEGate``). Each layer:

- RMSNorm; latent attention: ``q = x @ wq`` (no q LoRA), each head's 128
  nope and 64 rope dims; ``x @ wkv_a`` = (c_kv 512 ‖ k_pe 64), c_kv
  RMS-normed with ε 1e-6 (``DeepseekV3RMSNorm``'s default); ``c_kv @
  wkv_b`` = each head's (k_nope 128 ‖ v 128); RoPE on q_pe and on the one
  k_pe every head shares, the published way: the rope dims de-interleaved
  (``view(d/2, 2).transpose``) and then rotated by rotate-half; causal
  softmax at scale 1/sqrt(192); ``o @ wo``;
- RMSNorm; layer 0 (``first_k_dense_replace`` 1) a SwiGLU of 11264, every
  other layer the MoE block: sigmoid scores of ``x @ router`` in f32, the
  top-6 of score + correction bias (``noaux_tc``; ``n_group`` and
  ``topk_group`` 1, so the group limit chooses every group), weighted by
  the chosen unbiased scores over their sum + 1e-20 (``norm_topk_prob``),
  times ``routed_scaling_factor``; each token through its experts'
  SwiGLU, no capacity; plus the two shared experts as one SwiGLU of 2816,
  ungated.

Then the final RMSNorm and the untied head. No cache and no batching
tricks: every position of every row is computed from the tokens alone.
Departures, none of which changes the mathematics: an expert runs on the
rows that chose it (the published block's own loop over experts), and
RoPE's angles are computed in float64.

The weights are a nested dict, each projection stored (in, out) so that
``y = x @ w``, under the names of
``portbench/reference/moonlight_decode.py``'s docstring: the dense layer's
under ``dense_layers``, the MoE layers' under ``layers``, each stacked on a
leading axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

KV_NORM_EPS = 1e-6


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """The published RoPE of x (B, L, H, d) at positions 0 .. L-1: the
    pairs de-interleaved into halves, then rotate-half."""
    b, n, h, d = x.shape
    x = x.view(b, n, h, d // 2, 2).transpose(-1, -2).reshape(b, n, h, d)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(t, a, model):
    b, n, _ = t.shape
    h, r = model["num_attention_heads"], model["kv_lora_rank"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    vd = model["v_head_dim"]
    q = (t @ a["wq"]).view(b, n, h, nope + rope)
    kv = t @ a["wkv_a"]
    c_kv = _rms(kv[..., :r], a["kv_norm"], KV_NORM_EPS)
    k_pe = _rope(kv[..., None, r:], model["rope_theta"])
    kvb = (c_kv @ a["wkv_b"]).view(b, n, h, nope + vd)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], model["rope_theta"])],
                  dim=-1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(b, n, h, rope)], dim=-1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(nope + rope)
    mask = torch.ones(n, n, dtype=torch.bool).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, kvb[..., nope:])
    return o.reshape(b, n, h * vd) @ a["wo"]


def _swiglu(t, m):
    return (F.silu(t @ m["w_gate"]) * (t @ m["w_up"])) @ m["w_down"]


def _moe(t, lw, model):
    scores = torch.sigmoid(t @ lw["router"])                      # (T, E)
    choice = scores + lw["router_bias"]
    _, chosen = torch.topk(choice, model["num_experts_per_tok"], dim=-1)
    weight = scores.gather(1, chosen)
    if model["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * model["routed_scaling_factor"]
    y = torch.zeros_like(t)
    ex = lw["experts"]
    for e in range(model["n_routed_experts"]):
        tok, slot = torch.where(chosen == e)
        if tok.numel():
            out = _swiglu(t[tok], {k: w[e] for k, w in ex.items()})
            y.index_add_(0, tok, out * weight[tok, slot, None])
    return y + _swiglu(t, lw["shared"])


def _layer(x, lw, model, dense: bool):
    b, n, d = x.shape
    eps = model["rms_norm_eps"]
    x = x + _attention(_rms(x, lw["ln1"], eps), lw["attn"], model)
    t = _rms(x, lw["ln2"], eps)
    if dense:
        return x + _swiglu(t, lw["mlp"])
    return x + _moe(t.reshape(b * n, d), lw, model).view(b, n, d)


def _layer_weights(tree, i):
    return {name: _layer_weights(v, i) if isinstance(v, dict)
            else v[i].float() for name, v in tree.items()}


def forward(model: dict, w: dict, tokens) -> torch.Tensor:
    """Logits (B, L, V) in float32 of every position of ``tokens`` (B, L),
    ``model`` the published config.json's keys."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens = torch.as_tensor(tokens).long()
    k = model["first_k_dense_replace"]
    with torch.no_grad():
        x = w["embedding"][tokens].float()
        for i in range(model["num_hidden_layers"]):
            dense = i < k
            tree = w["dense_layers"] if dense else w["layers"]
            x = _layer(x, _layer_weights(tree, i if dense else i - k), model,
                       dense)
        x = _rms(x, w["final_norm"].float(), model["rms_norm_eps"])
        return x @ w["lm_head"].float()
