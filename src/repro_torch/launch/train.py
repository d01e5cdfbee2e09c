"""Training launcher (the JAX package's ``launch/train.py``, ported):
``python -m repro_torch.launch.train --arch <id> ...``.

It builds a model of the pool (``reduced()`` unless ``--no-reduced``), its
AdamW state and train step, a ``SyntheticLM`` stream and a ``Trainer``
under a ``Supervisor`` (restart from the latest checkpoint on failure,
straggler watch), runs ``--steps`` steps and prints the reference's step
and final lines. It runs on the card unless ``--device cpu``; without a
card it raises.

The step runs on a device mesh, as the reference's does: ``--mesh host``
is the one-device ``(1, 1)`` mesh, ``--mesh production`` the 16x16
``("data", "model")`` mesh of 256 ranks (started by a launcher that sets
``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``; a world of another size is
refused). Either way the layers' activation-sharding hooks are set for the
mesh, ``jit_train_step`` lays the state out (FSDP x TP) and each batch
over the data axis, and at the end the hooks are cleared and the process
group the mesh made is destroyed.

Run:  python -m repro_torch.launch.train --device cpu --steps 3
      python -m repro_torch.launch.train --no-reduced     (on the card)
"""

from __future__ import annotations

import argparse
import contextlib
import math

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     release_mesh)
from repro_torch.models import layers as model_layers
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.supervisor import Supervisor, SupervisorReport
from repro_torch.runtime.train_loop import (Trainer, init_train_state,
                                            jit_train_step, make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite_3_2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", choices=["host", "production"], default="host",
                    help="host: the one-device (1, 1) ('data', 'model') "
                         "mesh; production: the 16x16 ('data', 'model') "
                         "mesh of 256 ranks. Either lays the state out "
                         "FSDP x TP and the batch over 'data'")
    ap.add_argument("--remat", choices=("none", "full", "dots"),
                    default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def check_device(args: argparse.Namespace) -> None:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")


@contextlib.contextmanager
def train_mesh(args: argparse.Namespace):
    """The mesh ``--mesh`` names, with the layers' activation sharding set
    for it; on exit the hooks are cleared and a process group the mesh
    made is destroyed."""
    mesh = (make_production_mesh(device=args.device)
            if args.mesh == "production" else make_host_mesh(args.device))
    try:
        sizes = sh.axis_sizes(mesh)
        dp = math.prod(sizes[a] for a in sh.batch_axes(mesh))
        model_layers.set_activation_sharding(sh.batch_axes(mesh), dp,
                                             "model", sizes["model"])
        yield mesh
    finally:
        model_layers.clear_activation_sharding()
        release_mesh()


def opt_config(args: argparse.Namespace) -> AdamWConfig:
    """The optimizer ``args`` describe: warmup over the first twentieth of
    the steps, then cosine decay over the rest, no weight decay."""
    return AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps, weight_decay=0.0)


def make_trainer(args: argparse.Namespace, mesh=None) -> Trainer:
    """The model, optimizer state, step, data stream and checkpoint
    manager that ``args`` describe, in a ``Trainer``: the step through
    ``jit_train_step`` on ``mesh``, or on the device that holds the
    parameters without one."""
    check_device(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build(cfg, remat=args.remat, device=args.device)
    opt_cfg = opt_config(args)
    # drawn on the device: a host generator would stage a full-width
    # model's weights in host memory. On a mesh every rank draws the same
    # full state and keeps its shards.
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    state = init_train_state(bundle, generator, opt_cfg,
                             compress_grads=args.compress_grads)
    step = make_train_step(bundle, opt_cfg,
                           compress_grads=args.compress_grads,
                           grad_accum=args.grad_accum)
    state_sh = None
    if mesh is not None:
        step, state_sh, _ = jit_train_step(step, state, mesh, {"tokens": 2})
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch,
                       seed=args.seed)
    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    return Trainer(bundle, opt_cfg, data, state, step, ckpt,
                   checkpoint_every=args.checkpoint_every, shardings=state_sh)


def main(argv=None) -> SupervisorReport:
    args = parse_args(argv)
    check_device(args)
    with train_mesh(args) as mesh:
        trainer = make_trainer(args, mesh)
        report = Supervisor(trainer).run(args.steps)
    for rec in trainer.records[:: max(args.steps // 20, 1)]:
        print(f"step {rec.step:5d} loss {rec.loss:8.4f} "
              f"({rec.wall_s * 1e3:.0f} ms)")
    print(f"final loss {report.losses[-1]:.4f} "
          f"(restarts={report.restarts}, "
          f"stragglers={len(report.stragglers)})")
    return report


if __name__ == "__main__":
    main()
