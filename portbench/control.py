"""The readings the limits of ``check.py`` are set from, at a cell's own
sizes, in one process:

- the program's: one tuning session as the ``infer`` mix's set-up runs it,
  each op's schedule resolved and built, then one pass on each seed's
  inputs, its answers compared with the reference;
- the control's: the reference one precision below the configuration's
  (``reference/ops.py``: int4 operands for int8, bfloat16 for float32) put
  in the program's place on the same inputs.

    python3 portbench/control.py --workload mobilenetv2-int8-b96.infer \
        --seed 7 --seeds 12 --control-seeds 3

Prints one JSON line: each number's readings, seed by seed, for both. A
limit lies above the program's largest reading and below the control's
smallest. Needs a card, as the benchmark does; ``readings`` runs anywhere.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(cell, seed: int, seeds: int, control_seeds: int, device: str,
             runner_class) -> dict:
    from portbench import check, harness, inputs
    from portbench.loops import passes

    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=device, t0=time.perf_counter(),
                          runner_class=runner_class)
    config = cell.config
    _, db = passes.tune(ctx, cell.traffic)
    built, _ = passes.resolve(config, db, device)
    ops = inputs.expand(config)
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    for i in range(max(seeds, control_seeds)):
        launches_in = inputs.for_launches(config, seed + i, device)
        if i < seeds:
            answers = [harness.Answer(
                op["op"], args, built[(op["op"], tuple(op["dims"]))](*args))
                for op, args in zip(ops, launches_in)]
            ctx.sync()
            for name, value in check.readings(answers, config).items():
                program.setdefault(name, []).append(value)
        if i < control_seeds:
            answers = [harness.Answer(op["op"], args, None)
                       for op, args in zip(ops, launches_in)]
            for name, value in check.readings(answers, config,
                                              against="control").items():
                control.setdefault(name, []).append(value)
    return {"workload": cell.name, "seeds": [seed, seed + seeds - 1],
            "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(harness.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    from repro_torch.core.runner import CudaRunner

    out = readings(cell, args.seed, args.seeds, args.control_seeds, "cuda",
                   CudaRunner)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
