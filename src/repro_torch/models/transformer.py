"""Decoder-only transformer (dense GQA family; also the VLM backbone), the
JAX package's ``models/transformer.py`` ported.

The per-layer parameters are stacked with a leading ``(L, ...)`` dim under
the reference's leaf names (``layers.attn.wq`` is the reference's
``params["layers"]["attn"]["wq"]``), so the reference's vmapped init tree,
the checkpoint layout and :class:`Model`'s ``state_dict`` line up one
to one. The reference's ``lax.scan`` over layers is a loop over the layer
index here; per-layer attention windows come from the config, so one loop
expresses full, sliding-window and local:global interleaved patterns
(gemma3's 5:1, danube's SWA).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict entries become submodules,
    tensors parameters, under the same names. ``tree["name"]`` reads an
    entry, as the reference's functions read their parameter dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def layer_slice(tree: ParamTree, i: int) -> dict:
    """Layer ``i``'s parameters as a nested dict of views into the stacked
    ``(L, ...)`` tensors of ``tree``."""
    out = {}
    for name, child in tree.named_children():
        out[name] = layer_slice(child, i)
    for name, param in tree.named_parameters(recurse=False):
        out[name] = param[i]
    return out


class Model(ParamTree):
    """The parameters of one model of any family under the reference's
    names (``embedding``, ``lm_head`` when untied, the stacked layers or
    units, the norms) with its config; calling it is its family's
    ``forward`` (``family_forward(self, *inputs, cfg, **kwargs)``)."""

    def __init__(self, cfg: ArchConfig, tree: dict, family_forward):
        super().__init__(tree)
        self.cfg = cfg
        self._family_forward = family_forward

    def forward(self, *inputs, **kwargs):
        return self._family_forward(self, *inputs, self.cfg, **kwargs)


def _init_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_layers,)
    return {
        "ln1": L.init_norm(cfg.d_model, generator, stack),
        "attn": L.init_attention(cfg, generator, stack),
        "ln2": L.init_norm(cfg.d_model, generator, stack),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, cfg.act, generator, stack),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    tree = {
        **L.init_embedding(cfg, generator),
        "layers": _init_layers(cfg, generator),
        "final_norm": L.init_norm(cfg.d_model, generator),
    }
    return Model(cfg, tree, forward).to(device)


def _block(x, lp, window: int, cfg: ArchConfig, positions, mrope_positions):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, _ = L.attention(h, lp["attn"], cfg, positions, window,
                              mrope_positions)
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(h, lp["mlp"], cfg.act)


def _embed_inputs(params, tokens, cfg: ArchConfig, inputs_embeds):
    dtype = DTYPES[cfg.dtype]
    x = L.embed(tokens, params, cfg, dtype)
    if inputs_embeds is not None:
        n = inputs_embeds.shape[1]
        x = torch.cat([inputs_embeds.to(dtype), x[:, n:]], dim=1)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward(params: Model, tokens, cfg: ArchConfig, *,
            inputs_embeds=None, mrope_positions=None, remat: str = "full"):
    """tokens (B, S) -> logits (B, S, V).

    ``inputs_embeds`` (B, N, D) replaces the first N token embeddings — the
    VLM stub frontend injects precomputed patch embeddings this way.
    ``remat`` is accepted for the reference's signature and ignored: no
    backward pass runs in the port yet.
    """
    del remat
    x, positions = _embed_inputs(params, tokens, cfg, inputs_embeds)
    for i in range(cfg.n_layers):
        x = _block(x, layer_slice(params["layers"], i),
                   cfg.window_for_layer(i), cfg, positions, mrope_positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


# -------------------------------------------------------------------- decode --

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    dtype = dtype or DTYPES[cfg.dtype]
    t_alloc = L.ring_cache_len(cfg, max_len)  # = max_len unless RING_KV
    shape = (cfg.n_layers, batch, t_alloc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _uniform_window(cfg: ArchConfig) -> int | None:
    """The window every layer shares (e.g. danube's SWA-everywhere), or
    None."""
    if (cfg.window_pattern and cfg.window_pattern[0] > 0
            and all(w == cfg.window_pattern[0] for w in cfg.window_pattern)):
        return cfg.window_pattern[0]
    return None


@torch.no_grad()
def decode_step(params: Model, cache, tokens, pos: int,
                cfg: ArchConfig, *, mrope_positions=None):
    """One-token decode. tokens (B, 1); pos — write position.

    The stacked (L, B, T, H, hd) cache is written in place, layer by layer
    (each layer's attention writes into its view of the stack), so no second
    copy of it is made.

    Returns (logits (B, V), cache)."""
    x = L.embed(tokens, params, cfg, DTYPES[cfg.dtype])
    uniform_w = _uniform_window(cfg)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(
            h, lp["attn"], cfg, cache["k"][i], cache["v"][i], pos,
            cfg.window_for_layer(i), mrope_positions,
            static_window=uniform_w, ring=uniform_w is not None)
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], cfg.act)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, params, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def prefill(params: Model, tokens, cfg: ArchConfig, max_len: int, *,
            inputs_embeds=None, mrope_positions=None):
    """Forward + cache construction for serving. Returns (logits, cache)."""
    x, positions = _embed_inputs(params, tokens, cfg, inputs_embeds)
    dtype = DTYPES[cfg.dtype]
    cache = init_cache(cfg, tokens.shape[0], max_len, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, (k, v) = L.attention(h, lp["attn"], cfg, positions,
                                       cfg.window_for_layer(i),
                                       mrope_positions)
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], cfg.act)
        cache["k"][i] = L.ring_store(k.to(dtype), cfg, max_len)
        cache["v"][i] = L.ring_store(v.to(dtype), cfg, max_len)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), cache
