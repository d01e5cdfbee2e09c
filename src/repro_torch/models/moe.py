"""Mixture-of-Experts transformer (Qwen2-MoE / Moonshot family), the JAX
package's ``models/moe.py`` ported.

Routing uses top-k softmax with capacity-bounded sort-free dispatch
(scatter into per-expert slot buffers), which keeps dispatch memory at
O(tokens·top_k) instead of the O(tokens·experts·capacity) einsum form.
Experts are padded up to a multiple of 16 when needed (60 -> 64 for
qwen2-moe); the padding experts are never routed to.

The routing is the reference's decision for decision: ``lax.top_k``'s
lower-index-first order on ties, the stable sort that gives earlier tokens
capacity priority, the left-sided ``searchsorted`` and the dropped-token
slot ``e·cap``. The reference writes the backward of its dispatch and
combine by hand (a ``custom_vjp`` pair); here autograd derives the same
ones: the scatter's is a gather at the same slots (zero for a dropped
token, whose row is sliced off), the gather's a scatter-add.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def padded_experts(cfg: ArchConfig, ep: int = 16) -> int:
    e = cfg.n_experts
    return ((e + ep - 1) // ep) * ep if e % ep else e


def _init_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_layers,)
    d, fe = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg)
    p = {
        "ln1": L.init_norm(d, generator, stack),
        "attn": L.init_attention(cfg, generator, stack),
        "ln2": L.init_norm(d, generator, stack),
        "router": L._dense_init(stack + (d, e), generator),
        "experts": {
            "w_gate": L._dense_init(stack + (e, d, fe), generator),
            "w_up": L._dense_init(stack + (e, d, fe), generator),
            "w_down": L._dense_init(stack + (e, fe, d), generator),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(d, cfg.n_shared_experts * cfg.moe_d_ff,
                                 "silu", generator, stack)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> T.Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    tree = {
        **L.init_embedding(cfg, generator),
        "layers": _init_layers(cfg, generator),
        "final_norm": L.init_norm(cfg.d_model, generator),
    }
    return T.Model(cfg, tree, forward).to(device)


def route(x, router, cfg: ArchConfig):
    """The routing decision of ``x`` (B, S, D): ``(sel, gates, slot,
    cap)``. ``sel`` (B, S, k) holds each token's experts, best first (a tie
    goes to the lower index, as ``lax.top_k``'s); ``gates`` their softmax
    weights in x's dtype; ``slot`` (B, S·k) each assignment's row of the
    (E·cap) slot buffer, ``E·cap`` where capacity dropped it."""
    logits = (x @ router.to(x.dtype)).float()
    # each row's decision is its own (capacity counts along S): on a
    # DTensor, each rank routes its rows
    return L.by_rows(_route_rows, logits, x.dtype, cfg)


def _route_rows(logits, dtype, cfg: ArchConfig):
    b, s, _ = logits.shape
    e = padded_experts(cfg)
    k = cfg.top_k
    if e != cfg.n_experts:  # padding experts are never routed to
        pad_mask = torch.arange(e, device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(pad_mask, -1e30)
    # a stable descending sort keeps the lower index first among equals
    gate_vals, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_vals, sel = gate_vals[..., :k], sel[..., :k]         # (B, S, k)
    gates = torch.softmax(gate_vals, dim=-1).to(dtype)

    cap = max(8, int(math.ceil(s * k / e * cfg.capacity_factor)))
    flat_sel = sel.reshape(b, s * k)                          # (B, S*k)
    # Sort-based position-in-expert: the sort is stable, so earlier tokens
    # keep capacity priority.
    order = torch.argsort(flat_sel, dim=1, stable=True)
    sorted_e = torch.gather(flat_sel, 1, order)
    experts = torch.arange(e, device=logits.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)            # (B, E), left
    pos_sorted = (torch.arange(s * k, device=logits.device)[None]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.zeros_like(flat_sel).scatter_(1, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_sel * cap + pos,
                       torch.full_like(flat_sel, e * cap))
    return sel, gates, slot, cap


def _dispatch(x_rep, slot, n_slots: int):
    """(B, Sk, D) tokens -> (B, n_slots, D) expert slot buffer: a scatter
    into ``n_slots + 1`` rows, the last catching every dropped token. On
    DTensors each rank scatters its own rows (``by_rows``): no rank holds
    another's rows of the buffer."""
    return L.shard_act(L.by_rows(_scatter_rows, x_rep, slot, n_slots))


def _scatter_rows(x_rep, slot, n_slots: int):
    b, _, d = x_rep.shape
    buf = x_rep.new_zeros((b, n_slots + 1, d))
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), x_rep)
    return buf[:, :n_slots]


def _combine(out_flat, slot, n_slots: int):
    """(B, n_slots, D) expert outputs -> (B, Sk, D) per-token outputs, zero
    for a dropped token; on DTensors each rank gathers its own rows."""
    return L.shard_act(L.by_rows(_gather_rows, out_flat, slot, n_slots))


def _gather_rows(out_flat, slot, n_slots: int):
    keep = (slot < n_slots)[..., None]
    idx = torch.clamp(slot, max=n_slots - 1)[..., None]
    g = torch.gather(out_flat, 1, idx.expand(-1, -1, out_flat.shape[-1]))
    return torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))


def _expert_mlp(expert_in, we: dict):
    """Each expert's gated MLP on its slots: (B, E, C, D) -> (B, E, C, D)."""
    gate_h = F.silu(torch.einsum("becd,edf->becf", expert_in, we["w_gate"]))
    up_h = torch.einsum("becd,edf->becf", expert_in, we["w_up"])
    return torch.einsum("becf,efd->becd", gate_h * up_h, we["w_down"])


def moe_ffn(x, lp, cfg: ArchConfig):
    """x (B, S, D) -> (B, S, D): top-k routed experts + shared experts.

    Dispatch is grouped by batch row: the capacity count runs along S
    within each row."""
    b, s, d = x.shape
    e = padded_experts(cfg)
    k = cfg.top_k
    _, gates, slot, cap = route(x, lp["router"], cfg)

    x_rep = L.shard_act(x.repeat_interleave(k, dim=1))        # (B, S*k, D)
    expert_in = L.shard_expert(
        _dispatch(x_rep, slot, e * cap).reshape(b, e, cap, d))

    we = {k: w.to(x.dtype) for k, w in lp["experts"].items()}
    out = L.experts_local(_expert_mlp, expert_in, we)

    out_flat = L.shard_expert(out).reshape(b, e * cap, d)
    gathered = _combine(out_flat, slot, e * cap)
    y = (gathered.reshape(b, s, k, d) * gates[..., None]).sum(dim=2)

    if cfg.n_shared_experts:
        y = y + L.mlp(x, lp["shared"], "silu")
    return L.residual_branch(y)


def _block(x, lp, window: int, cfg: ArchConfig, positions):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, _ = L.attention(h, lp["attn"], cfg, positions, window)
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return L.shard_act(x + moe_ffn(h, lp, cfg), seq_model=True)


def _positions(tokens, x):
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def forward(params: T.Model, tokens, cfg: ArchConfig, *,
            remat: str = "full"):
    """tokens (B, S) -> logits (B, S, V). ``remat``: each layer's policy
    under autograd (:func:`~repro_torch.models.transformer.remat_layer`)."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    positions = _positions(tokens, x)
    block = T.remat_layer(_block, remat)
    layers = T.unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        x = block(x, layers[i],
                  cfg.window_for_layer(i), cfg, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


init_cache = T.init_cache


@torch.no_grad()
def decode_step(params: T.Model, cache, tokens, pos: int, cfg: ArchConfig):
    """One-token decode; the stacked KV cache is written in place."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    layers = T.unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(h, lp["attn"], cfg,
                                            cache["k"][i], cache["v"][i],
                                            pos, cfg.window_for_layer(i))
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + moe_ffn(h, lp, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)[:, 0], cache


@torch.no_grad()
def prefill(params: T.Model, tokens, cfg: ArchConfig, max_len: int):
    """Forward + KV cache (padded to ``max_len``). Returns (logits,
    cache)."""
    dtype = T.DTYPES[cfg.dtype]
    x = L.embed(tokens, params, cfg, dtype)
    positions = _positions(tokens, x)
    pad = max_len - tokens.shape[1]
    ks, vs = [], []
    layers = T.unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, (kk, vv) = L.attention(h, lp["attn"], cfg, positions,
                                         cfg.window_for_layer(i))
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + moe_ffn(h, lp, cfg)
        ks.append(L.pad(kk.to(dtype), (0, 0, 0, 0, 0, pad)))
        vs.append(L.pad(vv.to(dtype), (0, 0, 0, 0, 0, pad)))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), {"k": torch.stack(ks),
                                       "v": torch.stack(vs)}
