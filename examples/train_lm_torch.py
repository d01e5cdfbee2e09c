"""End-to-end driver for the PyTorch/CUDA port (``examples/train_lm.py``'s
flow): train a ~100M-parameter LM for a few hundred steps with the full
production stack — supervisor (fault tolerance), atomic checkpoints,
deterministic data pipeline, AdamW + cosine schedule, int8 gradient
compression with error feedback.

~100M params: mobilellm-125m's published architecture at full width/depth,
its weights drawn on the card from seed 0. It runs on the card and raises
without one; ``--cpu`` trains on the CPU instead, and ``--reduced`` takes
the architecture's small same-family config (a smoke run).

Run:  python examples/train_lm_torch.py [--steps 300] [--cpu] [--reduced]
"""

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.supervisor import Supervisor  # noqa: E402
from repro_torch.runtime.train_loop import (Trainer,  # noqa: E402
                                            init_train_state,
                                            make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--compress-grads", action="store_true", default=True)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--reduced", action="store_true",
                    help="mobilellm-125m's small same-family config")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to train on the CPU")

    cfg = get_config("mobilellm_125m")  # 30L x 576d, ~125M params
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build(cfg, remat="none", device=device)
    n_params = cfg.num_params()
    print(f"training {cfg.name}: {n_params / 1e6:.0f}M params, "
          f"seq {args.seq_len}, batch {args.batch}, {args.steps} steps "
          f"on {device}")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=args.steps // 10,
                          total_steps=args.steps, weight_decay=0.01)
    state = init_train_state(
        bundle, torch.Generator(device=device).manual_seed(0), opt_cfg,
        compress_grads=args.compress_grads)
    step = make_train_step(bundle, opt_cfg,
                           compress_grads=args.compress_grads)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=0)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir, keep=2)
        trainer = Trainer(bundle, opt_cfg, data, state, step, ckpt,
                          checkpoint_every=100)
        sup = Supervisor(trainer)
        report = sup.run(args.steps)

    first = report.losses[0]
    last = sum(report.losses[-10:]) / len(report.losses[-10:])
    for rec in trainer.records[:: max(args.steps // 15, 1)]:
        print(f"  step {rec.step:5d} loss {rec.loss:8.4f} "
              f"lr {rec.metrics['lr']:.2e} ({rec.wall_s * 1e3:.0f} ms)")
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(restarts={report.restarts})")
    if args.steps >= 100:  # short smoke runs may not clear warmup
        assert last < first, "training failed to reduce loss"


if __name__ == "__main__":
    main()
