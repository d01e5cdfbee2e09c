"""Uniform model API over the architecture families (the JAX package's
``models/model_zoo.py``, ported for the dense and vlm families).

``build(cfg)`` returns a :class:`ModelBundle` with the same entry points as
the reference's, so the serving loop treats every architecture alike:

    init(generator) -> params (a :class:`~repro_torch.models.transformer.Transformer`)
    loss_fn(params, batch) -> scalar f32 loss
    forward(params, batch) -> logits (B, S, V)
    prefill_fn(params, batch, max_len) -> (logits, cache)
    decode_fn(params, cache, tokens, pos) -> (logits (B,V), cache)
    init_cache(batch_size, max_len) -> cache dict
    make_batch(seed, shape, train) -> numpy batch

Batches may hold numpy arrays or tensors; they are moved to the device of
the parameters. ``init`` and ``init_cache`` place their tensors on the
bundle's ``device`` ("cuda" unless the caller asks for "cpu").
:func:`from_numpy_params` carries the JAX package's parameters (as numpy)
across, so both packages compute the same thing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import layers, transformer

# The families whose models are not ported yet, and where ROADMAP.md lists
# the work that ports them.
_UNPORTED = {"moe": "models/moe.py", "ssm": "models/ssm.py",
             "hybrid": "models/griffin.py", "encdec": "models/encdec.py"}
_ROADMAP_ITEM = "ROADMAP.md §1 item 7 (Models: the other families)"


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable
    make_batch: Callable
    device: torch.device = torch.device("cuda")


def _param_device(params) -> torch.device:
    return next(params.parameters()).device


def _inputs(params, batch: dict) -> dict:
    """The batch's entries as tensors on the parameters' device."""
    device = _param_device(params)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build(cfg: ArchConfig, remat: str = "full",
          device="cuda") -> ModelBundle:
    """The bundle of ``cfg``'s family. ``remat`` is accepted for the
    reference's signature and ignored (no backward pass runs yet)."""
    fam = cfg.family
    device = torch.device(device)
    if fam in _UNPORTED:
        raise NotImplementedError(
            f"the {fam} family ({_UNPORTED[fam]}) is not ported yet: "
            f"{_ROADMAP_ITEM}")
    if fam not in ("dense", "vlm"):
        raise ValueError(f"unknown family {fam}")
    mod = transformer

    def loss_fn(params, batch):
        batch = _inputs(params, batch)
        tokens = batch["tokens"]
        logits = mod.forward(params, tokens[:, :-1], cfg,
                             inputs_embeds=batch.get("patch_embeds"),
                             mrope_positions=batch.get("mrope_positions"),
                             remat=remat)
        return layers.lm_loss(logits, tokens[:, 1:])

    def forward(params, batch):
        batch = _inputs(params, batch)
        return mod.forward(params, batch["tokens"], cfg,
                           inputs_embeds=batch.get("patch_embeds"),
                           mrope_positions=batch.get("mrope_positions"),
                           remat=remat)

    def prefill_fn(params, batch, max_len):
        batch = _inputs(params, batch)
        return mod.prefill(params, batch["tokens"], cfg, max_len,
                           inputs_embeds=batch.get("patch_embeds"),
                           mrope_positions=batch.get("mrope_positions"))

    def decode_fn(params, cache, tokens, pos):
        tokens = torch.as_tensor(tokens, device=_param_device(params))
        return mod.decode_step(params, cache, tokens, pos, cfg)

    def init_cache(b, t):
        return mod.init_cache(cfg, b, t, device=device)

    def init(generator: torch.Generator):
        return mod.init_params(cfg, generator, device=device)

    def make_batch(seed: int, shape: ShapeSpec, train: bool = True):
        """Concrete batch for smoke tests / examples (numpy, host-side):
        the reference's recipe, so both packages get the same batch from
        the same seed."""
        rng = np.random.default_rng(seed)
        b, s = shape.global_batch, shape.seq_len
        extra = 1 if train else 0
        batch: dict[str, Any] = {
            "tokens": rng.integers(0, cfg.vocab_size,
                                   size=(b, s + extra)).astype(np.int32)
        }
        if fam == "vlm":
            n_patch = min(64, s // 2)
            batch["patch_embeds"] = rng.standard_normal(
                (b, n_patch, cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(s), (b, 3, s)).astype(np.int32)
            batch["mrope_positions"] = np.ascontiguousarray(pos)
        return batch

    return ModelBundle(cfg, init, loss_fn, forward, prefill_fn, decode_fn,
                       init_cache, make_batch, device)


def from_numpy_params(cfg: ArchConfig, tree: dict,
                      device="cuda") -> transformer.Transformer:
    """The port's parameters from the JAX package's parameter tree with
    numpy leaves (``jax.tree.map(np.asarray, bundle.init(key))``): the same
    names, shapes and values, on ``device``."""
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: {_ROADMAP_ITEM}")

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, dtype=np.float32))

    return transformer.Transformer(cfg, tensors(tree)).to(device)
