"""Training step construction and the host-side training loop (the JAX
package's ``runtime/train_loop.py``, ported).

The step differentiates the model's loss with autograd on its parameters
(the f32 masters) and applies :func:`repro_torch.optim.adamw.update`, which
writes the new parameters and moments in place. A train state is
``{"params": Model, "opt": {"m", "v", "step"[, "ef"]}}``; the port's
``CheckpointManager`` writes it in the reference's layout, so a checkpoint
of either package's ``Trainer`` restores in the other's.

Left out: ``jit_train_step`` and ``make_train_step``'s
``param_gather_specs``, which place the step's state and batch on a device
mesh (FSDP x TP shardings, ZeRO-3 gathers); they wait for the port of
``runtime/sharding.py`` (ROADMAP queue 1 item 9). The step here runs on the
device that holds the parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.optim import adamw, compression
from repro_torch.optim.tree import nest, tree_map


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


def make_train_step(bundle: ModelBundle, opt_cfg: adamw.AdamWConfig,
                    compress_grads: bool = False,
                    grad_accum: int = 1,
                    cast_params_once: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum`` > 1 splits the batch into microbatches run one after
    another, their losses and gradients summed and then divided, as the
    reference's ``scan`` does (activation-memory relief at fixed global
    batch).

    ``cast_params_once`` casts the f32 master weights to bf16 once, before
    the layers, instead of at every projection; the gradients still flow
    to the f32 masters through the cast.
    """

    def loss_fn(params, batch):
        if cast_params_once:
            params = T.cast_params(params, torch.bfloat16)
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
            micro_batches = {
                k: x.reshape(grad_accum, x.shape[0] // grad_accum,
                             *x.shape[1:]) for k, x in batch.items()}
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
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


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
                 checkpoint_every: int = 50):
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.data = data_iter
        self.state = state
        self.train_step = train_step
        self.ckpt = checkpoint_manager
        self.checkpoint_every = checkpoint_every
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

    def restore_latest(self, device=None):
        """Load the latest checkpoint into the state, on ``device`` (the
        bundle's when None): the port's form of the reference's
        ``shardings=``."""
        step, self.state, extra = self.ckpt.restore(
            self.state, device=device or self.bundle.device)
        self.step = step
        self.data.step = extra.get("data_step", step)
        return step
