"""Decoder-only transformer (dense GQA family; also the VLM backbone), the
JAX package's ``models/transformer.py`` ported.

The per-layer parameters are stacked with a leading ``(L, ...)`` dim under
the reference's leaf names (``layers.attn.wq`` is the reference's
``params["layers"]["attn"]["wq"]``), so the reference's vmapped init tree,
the checkpoint layout and :class:`Model`'s ``state_dict`` line up one
to one. The reference's ``lax.scan`` over layers is a loop over the layer
index here; per-layer attention windows come from the config, so one loop
expresses full, sliding-window and local:global interleaved patterns
(gemma3's 5:1, danube's SWA). Under autograd each layer body runs under the
reference's rematerialization policy (:func:`remat_layer`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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


def _entries(tree) -> list:
    """(name, child) pairs of a tree node: a ParamTree's submodules and
    parameters, or a dict's items."""
    if isinstance(tree, ParamTree):
        return [*tree.named_children(), *tree.named_parameters(recurse=False)]
    return list(tree.items())


def _is_node(child) -> bool:
    return isinstance(child, (ParamTree, dict))


def tree_tensors(tree) -> list:
    """Every tensor of a ParamTree or a nested dict of tensors."""
    return [t for _, child in _entries(tree)
            for t in (tree_tensors(child) if _is_node(child) else (child,))]


def cast_params(params, dtype) -> dict:
    """``params`` with every f32 tensor cast to ``dtype``, as a nested dict
    that the families read as they read a :class:`Model`; gradients flow
    back to the f32 masters through the casts."""
    if _is_node(params):
        return {name: cast_params(child, dtype)
                for name, child in _entries(params)}
    return params.to(dtype) if params.dtype == torch.float32 else params


def layer_slice(tree, i: int) -> dict:
    """Layer ``i``'s parameters as a nested dict of views into the stacked
    ``(L, ...)`` tensors of ``tree`` (a ParamTree or a nested dict)."""
    return {name: layer_slice(child, i) if _is_node(child) else child[i]
            for name, child in _entries(tree)}


def unbind_layers(tree) -> list[dict]:
    """Every layer's :func:`layer_slice`, from one ``unbind(0)`` of each
    stack. A forward takes its stacks apart with this once: ``unbind``'s
    backward is one ``stack`` of the layers' gradients, where ``param[i]``
    per layer gives each layer a ``select_backward`` that writes a zero
    tensor the size of the whole stack."""
    parts = {name: unbind_layers(child) if _is_node(child) else child.unbind(0)
             for name, child in _entries(tree)}
    n = len(next(iter(parts.values())))
    return [{name: part[i] for name, part in parts.items()}
            for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (``x @ w``, which
    autograd sees as ``mm``); recompute the rest, batched products
    (``bmm``: attention scores, experts) among them."""
    del ctx, args, kwargs
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer(body, remat: str):
    """``body`` (a layer) under the reference's rematerialization policy:
    ``"full"`` keeps only its inputs for the backward and recomputes the
    rest (``nothing_saveable``), ``"dots"`` keeps its matmul outputs too
    (``dots_with_no_batch_dims_saveable``), ``"none"`` keeps what autograd
    keeps. Without grad it is ``body``."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {remat!r}: full, dots or none")
    if remat == "none" or not torch.is_grad_enabled():
        return body
    kwargs = {"use_reentrant": False}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, L.in_remat(body), **kwargs)


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
    return L.shard_act(x + L.mlp(h, lp["mlp"], cfg.act), seq_model=True)


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
    ``remat``: each layer's policy under autograd (:func:`remat_layer`).
    """
    x, positions = _embed_inputs(params, tokens, cfg, inputs_embeds)
    block = remat_layer(_block, remat)
    layers = unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        x = block(x, layers[i],
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
    layers = unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
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
    """Forward + cache construction for serving. Returns (logits, cache):
    each layer's keys and values stacked, as the reference's scan stacks
    them (on a mesh the cache keeps the layout attention gave them)."""
    x, positions = _embed_inputs(params, tokens, cfg, inputs_embeds)
    dtype = DTYPES[cfg.dtype]
    ks, vs = [], []
    layers = unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, (k, v) = L.attention(h, lp["attn"], cfg, positions,
                                       cfg.window_for_layer(i),
                                       mrope_positions)
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(h, lp["mlp"], cfg.act)
        ks.append(L.ring_store(k.to(dtype), cfg, max_len))
        vs.append(L.ring_store(v.to(dtype), cfg, max_len))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), {"k": torch.stack(ks),
                                       "v": torch.stack(vs)}
