"""Training launcher (the JAX package's ``launch/train.py``, ported):
``python -m repro_torch.launch.train --arch <id> ...``.

It builds a model of the pool (``reduced()`` unless ``--no-reduced``), its
AdamW state and train step, a ``SyntheticLM`` stream and a ``Trainer``
under a ``Supervisor`` (restart from the latest checkpoint on failure,
straggler watch), runs ``--steps`` steps and prints the reference's step
and final lines. It runs on the card unless ``--device cpu``; without a
card it raises. ``--mesh host`` is the one device; ``--mesh production``
(the reference's FSDP x TP mesh) waits for the port of sharding and
raises.

Run:  python -m repro_torch.launch.train --device cpu --steps 3
      python -m repro_torch.launch.train --no-reduced     (on the card)
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.supervisor import Supervisor, SupervisorReport
from repro_torch.runtime.train_loop import (Trainer, init_train_state,
                                            make_train_step)


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
    ap.add_argument("--mesh", choices=["host", "production"], default="host")
    ap.add_argument("--remat", choices=("none", "full", "dots"),
                    default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The model, optimizer state, step, data stream and checkpoint
    manager that ``args`` describe, in a ``Trainer``."""
    if args.mesh == "production":
        raise NotImplementedError(
            "--mesh production shards the model over a device mesh, which "
            "the port does not have yet (ROADMAP queue 1 item 9: sharding "
            "and the mesh); --mesh host runs on one device")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build(cfg, remat=args.remat, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, weight_decay=0.0)
    # drawn on the device: a host generator would stage a full-width
    # model's weights in host memory
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    state = init_train_state(bundle, generator, opt_cfg,
                             compress_grads=args.compress_grads)
    step = make_train_step(bundle, opt_cfg,
                           compress_grads=args.compress_grads,
                           grad_accum=args.grad_accum)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch,
                       seed=args.seed)
    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    return Trainer(bundle, opt_cfg, data, state, step, ckpt,
                   checkpoint_every=args.checkpoint_every)


def main(argv=None) -> SupervisorReport:
    args = parse_args(argv)
    trainer = make_trainer(args)
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
