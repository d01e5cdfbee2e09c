"""Encoder-decoder transformer (Whisper-tiny backbone), the JAX package's
``models/encdec.py`` ported.

The conv audio frontend is a stub: the model consumes precomputed frame
embeddings (B, encoder_seq, D). Learned positional embeddings (no RoPE),
LayerNorm with bias, GeLU MLPs — the Whisper conventions. Decoder layers
carry self-attention (causal, KV cached at decode) and cross-attention
against the encoded frames, whose keys and values the prefill caches.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _init_ln(stack, d, generator):
    scale = L.init_norm(d, generator, stack)
    return {"scale": scale, "bias": torch.zeros_like(scale)}


def _ln(x, p, eps):
    return L.layer_norm(x, p["scale"], p["bias"], eps)


def _init_enc_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_encoder_layers,)
    return {
        "ln1": _init_ln(stack, cfg.d_model, generator),
        "attn": L.init_attention(cfg, generator, stack),
        "ln2": _init_ln(stack, cfg.d_model, generator),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, "gelu", generator, stack),
    }


def _init_dec_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_layers,)
    return {
        "ln1": _init_ln(stack, cfg.d_model, generator),
        "self_attn": L.init_attention(cfg, generator, stack),
        "ln2": _init_ln(stack, cfg.d_model, generator),
        "cross_attn": L.init_attention(cfg, generator, stack),
        "ln3": _init_ln(stack, cfg.d_model, generator),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, "gelu", generator, stack),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> T.Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    tree = {
        **L.init_embedding(cfg, generator),
        "enc_pos": L._dense_init((cfg.encoder_seq, cfg.d_model), generator,
                                 scale=0.02),
        "dec_pos": L._dense_init((cfg.max_decoder_pos(), cfg.d_model),
                                 generator, scale=0.02),
        "enc_layers": _init_enc_layers(cfg, generator),
        "dec_layers": _init_dec_layers(cfg, generator),
        "enc_norm": _init_ln((), cfg.d_model, generator),
        "final_norm": _init_ln((), cfg.d_model, generator),
    }
    return T.Model(cfg, tree, forward).to(device)


def _no_rope_sdpa(x, p, cfg: ArchConfig, kv=None, causal: bool = False):
    """Attention without RoPE. kv: (keys_src) for cross-attention."""
    src = kv if kv is not None else x
    b, s, _ = x.shape
    t = src.shape[1]
    q = L.split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, cfg.head_dim)
    k = L.split_heads(src @ p["wk"].to(x.dtype), cfg.n_kv_heads,
                      cfg.head_dim)
    v = L.split_heads(src @ p["wv"].to(x.dtype), cfg.n_kv_heads,
                      cfg.head_dim)
    out = L._sdpa(q, k, v,
                  rows=torch.arange(s, dtype=torch.int32, device=x.device),
                  cols=torch.arange(t, dtype=torch.int32, device=x.device),
                  window=-1, causal=causal)
    return L.residual_branch(out @ p["wo"].to(x.dtype)), (k, v)


def encode(params: T.Model, frames, cfg: ArchConfig):
    """frames (B, T_enc, D) precomputed stub embeddings -> (B, T_enc, D)."""
    dtype = T.DTYPES[cfg.dtype]
    x = frames.to(dtype) + params["enc_pos"][None].to(dtype)
    layers = T.unbind_layers(params["enc_layers"])
    for i in range(cfg.n_encoder_layers):
        lp = layers[i]
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        out, _ = _no_rope_sdpa(h, lp["attn"], cfg)  # bidirectional
        x = x + out
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], "gelu")
    return _ln(x, params["enc_norm"], cfg.norm_eps)


def _embed_dec(params, tokens, cfg: ArchConfig):
    dtype = T.DTYPES[cfg.dtype]
    x = L.embed(tokens, params, cfg, dtype)
    return x + params["dec_pos"][:tokens.shape[1]][None].to(dtype)


def _dec_layer(x, lp, enc, cfg: ArchConfig):
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    out, _ = _no_rope_sdpa(h, lp["self_attn"], cfg, causal=True)
    x = x + out
    h = _ln(x, lp["ln2"], cfg.norm_eps)
    out, _ = _no_rope_sdpa(h, lp["cross_attn"], cfg, kv=enc)
    x = x + out
    h = _ln(x, lp["ln3"], cfg.norm_eps)
    return L.shard_act(x + L.mlp(h, lp["mlp"], "gelu"), seq_model=True)


def forward(params: T.Model, frames, tokens, cfg: ArchConfig, *,
            remat: str = "full"):
    """Teacher-forced decode over encoded frames -> logits (B, S, V).
    ``remat``: each decoder layer's policy under autograd
    (:func:`~repro_torch.models.transformer.remat_layer`); the encoder's
    layers keep what autograd keeps, as the reference's do."""
    enc = encode(params, frames, cfg)
    x = _embed_dec(params, tokens, cfg)
    layer = T.remat_layer(_dec_layer, remat)
    for lp in T.unbind_layers(params["dec_layers"]):
        x = layer(x, lp, enc, cfg)
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


# -------------------------------------------------------------------- decode --

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    dtype = dtype or T.DTYPES[cfg.dtype]
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
             cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in (("k", kv), ("v", kv), ("ck", cross),
                                ("cv", cross))}


@torch.no_grad()
def prefill(params: T.Model, frames, tokens, cfg: ArchConfig, max_len: int):
    """Encode + teacher-forced pass capturing the self- and cross-attention
    KV caches. Returns (logits, cache)."""
    dtype = T.DTYPES[cfg.dtype]
    enc = encode(params, frames, cfg)
    x = _embed_dec(params, tokens, cfg)
    pad = max_len - tokens.shape[1]
    parts = {"k": [], "v": [], "ck": [], "cv": []}
    layers = T.unbind_layers(params["dec_layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        out, (kk, vv) = _no_rope_sdpa(h, lp["self_attn"], cfg, causal=True)
        x = x + out
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        out, (ck, cv) = _no_rope_sdpa(h, lp["cross_attn"], cfg, kv=enc)
        x = x + out
        h = _ln(x, lp["ln3"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], "gelu")
        parts["k"].append(L.pad(kk.to(dtype), (0, 0, 0, 0, 0, pad)))
        parts["v"].append(L.pad(vv.to(dtype), (0, 0, 0, 0, 0, pad)))
        parts["ck"].append(ck.to(dtype))
        parts["cv"].append(cv.to(dtype))
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), {name: torch.stack(values)
                                       for name, values in parts.items()}


@torch.no_grad()
def decode_step(params: T.Model, cache, tokens, pos: int, cfg: ArchConfig):
    """One decoder token against the cached self/cross KV; the self KV is
    written into the cache in place."""
    dtype = T.DTYPES[cfg.dtype]
    b = tokens.shape[0]
    pos = int(pos)
    x = L.embed(tokens, params, cfg, dtype)
    # dynamic_slice's clamp: the position row stays inside the table
    row = min(max(pos, 0), params["dec_pos"].shape[0] - 1)
    x = x + params["dec_pos"][row:row + 1][None].to(dtype)
    dev = x.device
    layers = T.unbind_layers(params["dec_layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        sa = lp["self_attn"]
        q = L.split_heads(h @ sa["wq"].to(dtype), cfg.n_heads, cfg.head_dim)
        k = L.split_heads(h @ sa["wk"].to(dtype), cfg.n_kv_heads,
                          cfg.head_dim)
        v = L.split_heads(h @ sa["wv"].to(dtype), cfg.n_kv_heads,
                          cfg.head_dim)
        # dynamic_update_slice's clamp: the write stays inside the cache
        write = min(max(pos, 0), k_c.shape[1] - 1)
        k_c[:, write:write + 1] = k
        v_c[:, write:write + 1] = v
        out = L._sdpa(q, k_c, v_c,
                      rows=torch.full((1,), pos, dtype=torch.int32,
                                      device=dev),
                      cols=torch.arange(k_c.shape[1], dtype=torch.int32,
                                        device=dev),
                      window=-1, causal=True)
        x = x + out @ sa["wo"].to(dtype)
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        ca = lp["cross_attn"]
        q = L.split_heads(h @ ca["wq"].to(dtype), cfg.n_heads, cfg.head_dim)
        ck, cv = cache["ck"][i], cache["cv"][i]
        out = L._sdpa(q, ck, cv,
                      rows=torch.zeros((1,), dtype=torch.int32, device=dev),
                      cols=torch.arange(ck.shape[1], dtype=torch.int32,
                                        device=dev),
                      window=-1, causal=False)
        x = x + out @ ca["wo"].to(dtype)
        h = _ln(x, lp["ln3"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], "gelu")
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)[:, 0], cache
