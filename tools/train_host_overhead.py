#!/usr/bin/env python3
"""The host cost of the sharded train step: the launcher's step without a
mesh against the same step through ``--mesh host`` (``jit_train_step`` on
the one-device mesh, every leaf a DTensor), in one process, and the aten
operations one plain step dispatches.

Prints one JSON line: the medians of steps 4 to the last, in ms, each
way, the aten operations a step and the extra host time an operation.

Run:  python tools/train_host_overhead.py --device cpu      (reduced)
      python tools/train_host_overhead.py --no-reduced      (on the card)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=14)
    opts = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import train as launch_train

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    argv = ["--device", opts.device, "--steps", str(opts.steps), "--lr",
            "3e-4"] + (["--no-reduced"] if opts.no_reduced else [])

    def median_ms(trainer):
        trainer.run(opts.steps)
        return statistics.median(r.wall_s for r in trainer.records[4:]) * 1e3

    args = launch_train.parse_args(argv)
    trainer = launch_train.make_trainer(args)
    plain = median_ms(trainer)
    count = Count()
    with count:
        trainer.run(1)
    del trainer
    with launch_train.train_mesh(args) as mesh:
        sharded = median_ms(launch_train.make_trainer(args, mesh))
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if opts.device == "cuda"
                   else "cpu"),
        "reduced": not opts.no_reduced, "plain_step_ms": plain,
        "mesh_host_step_ms": sharded, "aten_ops_a_step": count.n,
        "extra_us_an_op": (sharded - plain) * 1e3 / count.n}))


if __name__ == "__main__":
    main()
