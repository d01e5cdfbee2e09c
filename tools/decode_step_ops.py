"""Device operations and card time of a decode cell's graphed step.

    python3 tools/decode_step_ops.py --workload <decode cell> --seed <n> \
        [--steps 10] [--warmup 3]

Builds the cell's ``Server`` as the benchmark builds it (weights and prompts
drawn from ``--seed``, each step replayed as a CUDA graph), prefills, runs
``--warmup`` steps (the first captures the graph), then profiles ``--steps``
steps with ``torch.profiler`` and prints one JSON line: the device
operations a step (kernels and copies), the card's busy ms a step, the card
ms a step of each kernel name (the costliest 25), and of PyTorch's own
elementwise, copy, reduction, index and concatenation kernels together
(``at::native``'s: the small ops between the hand-written kernels and the
projections). Needs a card; imports neither JAX nor the JAX package.
Run it with ``PYTHONPATH=<tree>/src`` to measure another tree's program
on the same card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    from portbench.loops import decode

    cell = harness.find_cell(harness.load_manifest(), args.workload)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=0.0,
                          trace=False, device="cuda", t0=time.perf_counter(),
                          runner_class=None)
    server, _, ids = harness.loop_module(cell).serve(ctx, args.seed)
    rows = decode.Rows(server, ids, cell.config["ops"][0]["dims"][2])
    for _ in range(args.warmup):
        rows.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            rows.step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_user_annotation()]
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in ops:
        by_name[e.name()[:96]] += e.duration_ns()
        calls[e.name()[:96]] += 1
    small = sum(ns for name, ns in by_name.items() if "at::native" in name)
    small_ops = sum(n for name, n in calls.items() if "at::native" in name)
    per = 1e6 * args.steps
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "steps": args.steps,
        "device": torch.cuda.get_device_name(0),
        "ops_per_step": len(ops) / args.steps,
        "busy_ms_per_step": sum(e.duration_ns() for e in ops) / per,
        "at_native_ops_per_step": small_ops / args.steps,
        "at_native_ms_per_step": small / per,
        "kernels_ms_per_step": {name: [ns / per, calls[name] / args.steps]
                                for name, ns in by_name.most_common(25)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
