"""Uniform model API over all architecture families (the JAX package's
``models/model_zoo.py``, ported).

``build(cfg)`` returns a :class:`ModelBundle` with the same entry points as
the reference's, so the serving loop treats every architecture alike:

    init(generator) -> params (a :class:`~repro_torch.models.transformer.Model`)
    loss_fn(params, batch) -> scalar f32 loss
    forward(params, batch) -> logits (B, S, V)
    prefill_fn(params, batch, max_len) -> (logits, cache)
    decode_fn(params, cache, tokens, pos) -> (logits (B,V), cache)
    init_cache(batch_size, max_len) -> cache dict
    make_batch(seed, shape, train) -> numpy batch

Batches may hold numpy arrays or tensors; they are moved to the device of
the parameters. The encoder-decoder family reads its stub frame embeddings
from ``batch["frames"]``. ``init`` and ``init_cache`` place their tensors
on the bundle's ``device`` ("cuda" unless the caller asks for "cpu"; on
"meta" ``init`` draws nothing and returns the parameters' shapes, the
counterpart of the reference's ``jax.eval_shape`` of ``bundle.init``).
:func:`from_numpy_params` carries the JAX package's parameters (as numpy)
across, so both packages compute the same thing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import encdec, griffin, layers, moe, ssm, transformer

# The module that implements each family.
FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
            "ssm": ssm, "hybrid": griffin, "encdec": encdec}


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


def param_device(params) -> torch.device:
    if isinstance(params, dict):  # a cast_params tree
        return transformer.tree_tensors(params)[0].device
    return next(params.parameters()).device


def _inputs(params, batch: dict) -> dict:
    """The batch's entries as tensors on the parameters' device."""
    device = param_device(params)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return FAMILIES[cfg.family]


def build(cfg: ArchConfig, remat: str = "full",
          device="cuda") -> ModelBundle:
    """The bundle of ``cfg``'s family. ``remat`` is each layer body's
    rematerialization policy under autograd: ``"full"``, ``"dots"`` or
    ``"none"`` (:func:`~repro_torch.models.transformer.remat_layer`).
    ``params`` may also be a nested dict of tensors under the same names
    (:func:`~repro_torch.models.transformer.cast_params`)."""
    fam = cfg.family
    mod = _family(cfg)
    device = torch.device(device)

    def model_inputs(batch, tokens):
        """The positional and keyword inputs of the family's forward and
        prefill besides the parameters and the config."""
        if fam == "encdec":
            return (batch["frames"], tokens), {}
        if fam in ("dense", "vlm"):
            return (tokens,), {
                "inputs_embeds": batch.get("patch_embeds"),
                "mrope_positions": batch.get("mrope_positions")}
        return (tokens,), {}

    def loss_fn(params, batch):
        batch = _inputs(params, batch)
        tokens = batch["tokens"]
        args, kwargs = model_inputs(batch, tokens[:, :-1])
        logits = mod.forward(params, *args, cfg, remat=remat, **kwargs)
        return layers.lm_loss(logits, tokens[:, 1:])

    def forward(params, batch):
        batch = _inputs(params, batch)
        args, kwargs = model_inputs(batch, batch["tokens"])
        return mod.forward(params, *args, cfg, remat=remat, **kwargs)

    def prefill_fn(params, batch, max_len):
        batch = _inputs(params, batch)
        args, kwargs = model_inputs(batch, batch["tokens"])
        return mod.prefill(params, *args, cfg, max_len, **kwargs)

    def decode_fn(params, cache, tokens, pos):
        tokens = torch.as_tensor(tokens, device=param_device(params))
        return mod.decode_step(params, cache, tokens, pos, cfg)

    def init_cache(b, t):
        return mod.init_cache(cfg, b, t, device=device)

    def init(generator: torch.Generator):
        if device.type == "meta":  # shapes only: nothing is drawn
            generator = layers.MetaGenerator()
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
        if fam == "encdec":
            batch["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return batch

    return ModelBundle(cfg, init, loss_fn, forward, prefill_fn, decode_fn,
                       init_cache, make_batch, device)


def from_numpy_params(cfg: ArchConfig, tree: dict,
                      device="cuda") -> transformer.Model:
    """The port's parameters from the JAX package's parameter tree with
    numpy leaves (``jax.tree.map(np.asarray, bundle.init(key))``), for any
    family: the same names, shapes and values, on ``device``."""
    mod = _family(cfg)

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, dtype=np.float32))

    return transformer.Model(cfg, tensors(tree), mod.forward).to(device)
