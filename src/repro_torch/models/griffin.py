"""Griffin / RecurrentGemma hybrid: RG-LRU recurrent blocks + local
attention, the JAX package's ``models/griffin.py`` ported.

The layers follow the repeating pattern (rec, rec, attn): for 26 layers,
8 full units and a tail of 2 recurrent blocks, stacked under the
reference's names (``units.rec1``, ``units.rec2``, ``units.attn``,
``tail``). The RG-LRU linear recurrence runs as a log-depth scan over the
sequence (train/prefill; the reference's ``associative_scan``) and an O(1)
state update at decode. The attention blocks are local (a sliding window)
and decode on a ring KV cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.ssm import causal_conv

C_GATE = 8.0  # RG-LRU gate exponent constant (Griffin, eq. 4)


# ----------------------------------------------------------------- init ------

def _init_rec(cfg: ArchConfig, generator: torch.Generator, n: int) -> dict:
    stack = (n,)
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    zeros = torch.zeros(stack + (w,), dtype=torch.float32,
                        device=generator.device)
    return {
        "ln1": L.init_norm(d, generator, stack),
        "w_x": L._dense_init(stack + (d, w), generator),
        "w_y": L._dense_init(stack + (d, w), generator),
        "conv_w": L._dense_init(stack + (cfg.conv_kernel, w), generator,
                                scale=0.1),
        "conv_b": zeros.clone(),
        "w_a": L._dense_init(stack + (w, w), generator),
        "b_a": zeros.clone(),
        "w_i": L._dense_init(stack + (w, w), generator),
        "b_i": zeros.clone(),
        "lam": torch.full(stack + (w,), 2.0, dtype=torch.float32,
                          device=generator.device),  # Λ init: a ~ 0.95
        "w_out": L._dense_init(stack + (w, d), generator),
        "ln2": L.init_norm(d, generator, stack),
        "mlp": L.init_mlp(d, cfg.d_ff, cfg.act, generator, stack),
    }


def _init_attn(cfg: ArchConfig, generator: torch.Generator, n: int) -> dict:
    stack = (n,)
    return {
        "ln1": L.init_norm(cfg.d_model, generator, stack),
        "attn": L.init_attention(cfg, generator, stack),
        "ln2": L.init_norm(cfg.d_model, generator, stack),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, cfg.act, generator, stack),
    }


def _unit_counts(cfg: ArchConfig):
    pat = len(cfg.block_pattern)  # (rec, rec, attn)
    n_units = cfg.n_layers // pat
    n_tail = cfg.n_layers - n_units * pat  # leftover 'rec' blocks
    return n_units, n_tail


def _tail_layers(params, cfg: ArchConfig) -> list[dict]:
    """The leftover recurrent layers' parameters (none for a whole number
    of units)."""
    return T.unbind_layers(params["tail"]) if _unit_counts(cfg)[1] else []


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> T.Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    n_units, n_tail = _unit_counts(cfg)
    tree = {
        **L.init_embedding(cfg, generator),
        "units": {"rec1": _init_rec(cfg, generator, n_units),
                  "rec2": _init_rec(cfg, generator, n_units),
                  "attn": _init_attn(cfg, generator, n_units)},
        "final_norm": L.init_norm(cfg.d_model, generator),
    }
    if n_tail:
        tree["tail"] = _init_rec(cfg, generator, n_tail)
    return T.Model(cfg, tree, forward).to(device)


# ----------------------------------------------------------------- RG-LRU ----

def _gates(branch, p):
    r = torch.sigmoid(branch @ p["w_a"].to(branch.dtype)
                      + p["b_a"].to(branch.dtype))
    i = torch.sigmoid(branch @ p["w_i"].to(branch.dtype)
                      + p["b_i"].to(branch.dtype))
    log_a = -C_GATE * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i.float() * branch.float()


def rg_lru(branch, p, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + β_t i_t x_t, as a log-depth
    (Hillis-Steele) scan over the sequence. branch (B,S,W). Returns (h
    (B,S,W), h_last (B,W) f32)."""
    a, b = _gates(branch, p)
    # pin batch sharding of the f32 gate tensors: the scan communicates
    # along S, so B must stay partitioned
    a, b = L.shard_act(a), L.shard_act(b)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    s = a.shape[1]
    off = 1
    while off < s:  # (a, b) at t combines with (a, b) at t - off
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b.to(branch.dtype), b[:, -1]


def _conv(branch, p):
    return causal_conv(branch, p["conv_w"], p["conv_b"])


def recurrent_block_seq(x, p, cfg: ArchConfig):
    """Temporal mixing of one recurrent block over a sequence."""
    branch = _conv(x @ p["w_x"].to(x.dtype), p)
    h, _ = rg_lru(branch, p)
    y = F.gelu(x @ p["w_y"].to(x.dtype), approximate="tanh") * h
    return L.residual_branch(y @ p["w_out"].to(x.dtype))


def _rec_layer(x, p, cfg: ArchConfig):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + recurrent_block_seq(h, p, cfg)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(h, p["mlp"], cfg.act)


def _attn_layer(x, p, cfg: ArchConfig, positions, window: int):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    out, kv = L.attention(h, p["attn"], cfg, positions, window)
    x = x + out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(h, p["mlp"], cfg.act), kv


def _window(cfg: ArchConfig) -> int:
    return cfg.window_pattern[0] if cfg.window_pattern else -1


def _unit(x, unit, cfg: ArchConfig, positions, window: int):
    x = _rec_layer(x, unit["rec1"], cfg)
    x = _rec_layer(x, unit["rec2"], cfg)
    return L.shard_act(_attn_layer(x, unit["attn"], cfg, positions,
                                   window)[0], seq_model=True)


def forward(params: T.Model, tokens, cfg: ArchConfig, *,
            remat: str = "full"):
    """tokens (B, S) -> logits (B, S, V). ``remat``: the policy of each
    unit and each tail layer under autograd
    (:func:`~repro_torch.models.transformer.remat_layer`)."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    window = _window(cfg)
    unit = T.remat_layer(_unit, remat)
    rec_layer = T.remat_layer(_rec_layer, remat)
    for unit_p in T.unbind_layers(params["units"]):
        x = unit(x, unit_p, cfg, positions, window)
    for lp in _tail_layers(params, cfg):
        x = rec_layer(x, lp, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


# -------------------------------------------------------------------- decode --

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    dtype = dtype or T.DTYPES[cfg.dtype]
    n_units, n_tail = _unit_counts(cfg)
    w = cfg.lru_width or cfg.d_model
    k = cfg.conv_kernel - 1
    t_alloc = L.ring_cache_len(cfg, max_len)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (n_units, batch, t_alloc, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": zeros(kv), "v": zeros(kv),
             "h1": zeros((n_units, batch, w), torch.float32),
             "c1": zeros((n_units, batch, k, w)),
             "h2": zeros((n_units, batch, w), torch.float32),
             "c2": zeros((n_units, batch, k, w))}
    if n_tail:
        cache["ht"] = zeros((n_tail, batch, w), torch.float32)
        cache["ct"] = zeros((n_tail, batch, k, w))
    return cache


def _rec_decode(x, p, cfg: ArchConfig, h_prev, conv_c):
    """x (B,D) one token. Returns (out, h, conv_c)."""
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    branch = hx @ p["w_x"].to(x.dtype)                  # (B,W)
    window = torch.cat([conv_c, branch[:, None]], dim=1)
    w = p["conv_w"].to(x.dtype)
    branch = (window * w[None]).sum(dim=1) + p["conv_b"].to(x.dtype)
    conv_c = window[:, 1:]
    a, b = _gates(branch, p)
    h = a * h_prev + b                                  # (B,W) f32
    y = F.gelu(hx @ p["w_y"].to(x.dtype), approximate="tanh") * h.to(x.dtype)
    x = x + y @ p["w_out"].to(x.dtype)
    hh = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(hh, p["mlp"], cfg.act), h, conv_c


@torch.no_grad()
def decode_step(params: T.Model, cache, tokens, pos: int, cfg: ArchConfig):
    """One-token decode; the recurrent states, conv inputs and the ring KV
    cache are written into ``cache`` in place."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])  # (B,1,D)
    window = _window(cfg)
    for u, unit in enumerate(T.unbind_layers(params["units"])):
        h = x[:, 0]
        h, cache["h1"][u], cache["c1"][u] = _rec_decode(
            h, unit["rec1"], cfg, cache["h1"][u], cache["c1"][u])
        h, cache["h2"][u], cache["c2"][u] = _rec_decode(
            h, unit["rec2"], cfg, cache["h2"][u], cache["c2"][u])
        h = h[:, None]
        hn = L.rms_norm(h, unit["attn"]["ln1"], cfg.norm_eps)
        out, _, _ = L.attention_decode(hn, unit["attn"]["attn"], cfg,
                                       cache["k"][u], cache["v"][u], pos,
                                       window, static_window=window,
                                       ring=window > 0)
        h = h + out
        hn = L.rms_norm(h, unit["attn"]["ln2"], cfg.norm_eps)
        x = h + L.mlp(hn, unit["attn"]["mlp"], cfg.act)
    for t, lp in enumerate(_tail_layers(params, cfg)):
        h, cache["ht"][t], cache["ct"][t] = _rec_decode(
            x[:, 0], lp, cfg, cache["ht"][t], cache["ct"][t])
        x = h[:, None]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)[:, 0], cache


@torch.no_grad()
def prefill(params: T.Model, tokens, cfg: ArchConfig, max_len: int):
    """Forward with cache capture (attention KV + final recurrent states).
    Returns (logits, cache)."""
    dtype = T.DTYPES[cfg.dtype]
    x = L.embed(tokens, params, cfg, dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    window = _window(cfg)
    kc = cfg.conv_kernel - 1

    def rec_seq(carry, p):
        h = L.rms_norm(carry, p["ln1"], cfg.norm_eps)
        pre_conv = h @ p["w_x"].to(h.dtype)
        hseq, h_last = rg_lru(_conv(pre_conv, p), p)
        y = F.gelu(h @ p["w_y"].to(h.dtype), approximate="tanh") * hseq
        out = carry + y @ p["w_out"].to(h.dtype)
        hh = L.rms_norm(out, p["ln2"], cfg.norm_eps)
        return out + L.mlp(hh, p["mlp"], cfg.act), h_last, pre_conv[:, -kc:]

    parts = {name: [] for name in ("k", "v", "h1", "c1", "h2", "c2")}
    for unit in T.unbind_layers(params["units"]):
        x, h1, c1 = rec_seq(x, unit["rec1"])
        x, h2, c2 = rec_seq(x, unit["rec2"])
        x, (kk, vv) = _attn_layer(x, unit["attn"], cfg, positions, window)
        for name, value in (("k", L.ring_store(kk.to(dtype), cfg, max_len)),
                            ("v", L.ring_store(vv.to(dtype), cfg, max_len)),
                            ("h1", h1), ("c1", c1), ("h2", h2), ("c2", c2)):
            parts[name].append(value)
    tail = _tail_layers(params, cfg)
    if tail:
        parts.update(ht=[], ct=[])
        for lp in tail:
            x, ht, ct = rec_seq(x, lp)
            parts["ht"].append(ht)
            parts["ct"].append(ct)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), {name: torch.stack(values)
                                       for name, values in parts.items()}
