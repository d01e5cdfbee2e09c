"""Training step construction and the host-side training loop (the JAX
package's ``runtime/train_loop.py``, ported).

The step differentiates the model's loss with autograd on its parameters
(the f32 masters) and applies :func:`repro_torch.optim.adamw.update`, which
writes the new parameters and moments in place. A train state is
``{"params": Model, "opt": {"m", "v", "step"[, "ef"]}}``; the port's
``CheckpointManager`` writes it in the reference's layout, so a checkpoint
of either package's ``Trainer`` restores in the other's.

:func:`jit_train_step` lays the state out on a device mesh (FSDP x TP
parameter shardings from ``runtime/sharding.py``, the moments and error
feedback like the parameters, the step replicated) as DTensors, and
returns a step that lays each batch out over the data-parallel axes;
``make_train_step``'s ``param_gather_specs`` gathers the parameters once a
step before the layers (ZeRO-3), whose backward reduce-scatters the
gradients into the storage layout. Without a mesh the step runs on the
device that holds the parameters.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch
from torch import nn

from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.optim import adamw, compression
from repro_torch.optim.tree import nest, tree_map
from repro_torch.runtime import sharding as sh


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     opt_cfg: adamw.AdamWConfig,
                     compress_grads: bool = False):
    """Parameters drawn from ``generator`` on the bundle's device, zero
    moments (and a zero error-feedback tree with ``compress_grads``)."""
    params = bundle.init(generator)
    opt_state = adamw.init(params)
    if compress_grads:
        opt_state["ef"] = compression.init_error_feedback(params)
    return {"params": params, "opt": opt_state}


def _full(x):
    """A DTensor's full value (every rank takes part), else ``x``."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def gather_params(params, specs) -> dict:
    """``params`` (DTensor leaves) as a nested dict whose leaves are laid
    out by ``specs`` (a tree of specs on the leaves' own meshes): the
    reference's ``with_sharding_constraint(params, specs)``. Autograd's
    backward of each redistribution lays the gradient out as the leaf is."""
    return tree_map(lambda x, spec: x.redistribute(
        x.device_mesh, sh.placements(spec, x.device_mesh)), params, specs)


def _microbatches(x, n: int) -> list:
    """``x`` split along dim 0 into ``n`` microbatches in order (the
    reference's ``reshape(n, B // n, ...)``). A DTensor's batch shards are
    gathered first and each microbatch laid out as ``x`` is: DTensor cannot
    unflatten a sharded dim into ``n`` rows the mesh does not divide. A
    microbatch whose rows the batch shards do not divide stays
    replicated, as ``token_sharding`` leaves such a batch."""
    from torch.distributed.tensor import DTensor, Replicate

    rows = x.shape[0] // n
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
        shards = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                           if p.is_shard(0))
        placements = x.placements if rows % shards == 0 else whole.placements
        return [part.redistribute(mesh, placements) for part in
                whole.reshape(n, rows, *x.shape[1:]).unbind(0)]
    return x.reshape(n, rows, *x.shape[1:])


def make_train_step(bundle: ModelBundle, opt_cfg: adamw.AdamWConfig,
                    compress_grads: bool = False,
                    grad_accum: int = 1,
                    cast_params_once: bool = False,
                    param_gather_specs=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum`` > 1 splits the batch into microbatches run one after
    another, their losses and gradients summed and then divided, as the
    reference's ``scan`` does (activation-memory relief at fixed global
    batch).

    ``cast_params_once`` casts the f32 master weights to bf16 once, before
    the layers, instead of at every projection; the gradients still flow
    to the f32 masters through the cast.

    ``param_gather_specs``: explicit ZeRO-3 semantics — a tree of specs
    (the storage specs minus the data axis) for a state laid out by
    :func:`jit_train_step`. Weights are gathered ONCE per step before the
    layers, and the backward of the gather reduce-scatters the gradients
    back to the FSDP layout. Without it, DTensor resolves each op on
    FSDP-sharded weights on its own.
    """

    def loss_fn(params, batch):
        if cast_params_once:
            params = T.cast_params(params, torch.bfloat16)
        if param_gather_specs is not None:
            params = gather_params(params, param_gather_specs)
        return bundle.loss_fn(params, batch)

    def value_and_grad(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), nest(dict(zip(names, grads)))

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        if grad_accum == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            micro_batches = {k: _microbatches(x, grad_accum)
                             for k, x in batch.items()}
            loss, grads = 0.0, tree_map(torch.zeros_like, params)
            for i in range(grad_accum):
                l, g = value_and_grad(
                    params, {k: x[i] for k, x in micro_batches.items()})
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)

        if compress_grads:
            grads, new_ef = compression.compress_with_feedback(
                grads, opt_state["ef"])
        new_params, new_opt, metrics = adamw.update(
            grads, {k: v for k, v in opt_state.items() if k != "ef"},
            params, opt_cfg)
        if compress_grads:
            new_opt["ef"] = new_ef
        metrics = {k: _full(v) for k, v in dict(metrics, loss=loss).items()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def place_state(node, shardings):
    """Lay ``node``'s leaves out by ``shardings`` (a tree of the same
    structure, a :class:`~repro_torch.runtime.sharding.NamedSharding` at
    each leaf), in place: a module's parameters become parameters holding
    DTensors, a dict's entries DTensors. Every rank holds the same full
    value beforehand and keeps its own shard. Returns ``node``."""
    if isinstance(node, nn.Module):
        for name, p in list(node.named_parameters()):
            *owner, leaf = name.split(".")
            s = shardings
            for key in name.split("."):
                s = s[key]
            setattr(node.get_submodule(".".join(owner)), leaf,
                    nn.Parameter(s.place(p), requires_grad=p.requires_grad))
        return node
    if isinstance(node, dict):
        for key in node:
            node[key] = place_state(node[key], shardings[key])
        return node
    return shardings.place(node)


def _on_host(v, mesh):
    """A batch entry as a tensor on the mesh's device type; a meta tensor
    (a dry run's shape stand-in) stays on meta."""
    if torch.is_tensor(v) and v.is_meta:
        return v
    return torch.as_tensor(v, device=mesh.device_type)


def jit_train_step(train_step, state, mesh, batch_ndim: dict[str, int]):
    """Lay ``state`` out on ``mesh`` (in place: FSDP x TP parameter
    shardings, the moments and error feedback like the parameters, the
    step replicated) and return ``(step, state_sh, batch_sh)``: ``step``
    lays each batch entry out by ``token_sharding`` (batch over the
    data-parallel axes) and runs ``train_step`` on DTensors, plain tensors
    it meets (positions, masks, tables) taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    param_sh = sh.param_shardings(state["params"], mesh)
    opt_sh = {}
    for k in state["opt"]:
        if k in ("m", "v", "ef"):
            opt_sh[k] = param_sh
        else:
            opt_sh[k] = sh.replicated(mesh)
    state_sh = {"params": param_sh, "opt": opt_sh}
    batch_sh = {k: sh.token_sharding(mesh, nd)
                for k, nd in batch_ndim.items()}
    place_state(state, state_sh)

    def step(state, batch):
        batch = {k: batch_sh[k].place(_on_host(v, mesh))
                 for k, v in batch.items()}
        with implicit_replication():
            return train_step(state, batch)

    return step, state_sh, batch_sh


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    wall_s: float
    metrics: dict[str, float]


class Trainer:
    """Host-side loop: data -> step -> metrics, checkpoint hooks."""

    def __init__(self, bundle: ModelBundle, opt_cfg: adamw.AdamWConfig,
                 data_iter, state, train_step, checkpoint_manager=None,
                 checkpoint_every: int = 50, shardings=None):
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.data = data_iter
        self.state = state
        self.train_step = train_step
        self.ckpt = checkpoint_manager
        self.checkpoint_every = checkpoint_every
        # the state's layout (jit_train_step's state_sh), None unsharded
        self.shardings = shardings
        self.step = 0
        self.records: list[StepRecord] = []

    def run(self, n_steps: int,
            step_callback: Callable[[StepRecord], None] | None = None):
        for _ in range(n_steps):
            batch = self.data.batch_at(self.step)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])  # waits for the step's device work
            wall = time.perf_counter() - t0
            rec = StepRecord(self.step, loss, wall,
                             {k: float(v) for k, v in metrics.items()})
            self.records.append(rec)
            self.step += 1
            if step_callback:
                step_callback(rec)
            if (self.ckpt is not None and self.checkpoint_every
                    and self.step % self.checkpoint_every == 0):
                self.save_checkpoint()
        return self.records

    def save_checkpoint(self):
        self.ckpt.save(self.step, self.state,
                       extra={"data_step": self.step})

    def restore_latest(self, shardings=None, device=None):
        """Load the latest checkpoint into the state: laid out by
        ``shardings`` (the trainer's own when neither is given), else on
        ``device`` (the bundle's when None)."""
        if shardings is None and device is None:
            shardings = self.shardings
        step, self.state, extra = self.ckpt.restore(
            self.state, device=device or self.bundle.device,
            shardings=shardings)
        self.step = step
        self.data.step = extra.get("data_step", step)
        return step
