"""The readings the limit of a decode cell's comparison is set from, at the
cell's own sizes, in one process (``control.py`` serves the ``passes``
cells):

- the program's: on each seed's weights and prompts, the ``Server``'s
  prefill and ``--steps`` decode steps, as the ``decode`` loop's set-up
  runs them; the first and the last step's logits compared with the
  reference's;
- the control's: the reference one precision below the configuration's
  (float8 e4m3 at every matmul input, ``reference/<op>.py``'s
  ``control``) on the same weights and tokens, compared with the
  reference's.

    python3 portbench/control_decode.py \
        --workload qwen1.5-moe-a2.7b-b4.decode --seed 7 --seeds 12 \
        --control-seeds 3

Prints one JSON line: each number's readings, seed by seed, for both, and
the program's MoE counters over all its steps. A limit lies above the
program's largest reading and below the control's smallest. Needs a card,
as the benchmark does; ``readings`` runs anywhere.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(cell, seed: int, seeds: int, control_seeds: int, steps: int,
             device: str) -> dict:
    import gc

    import torch
    from portbench import check, harness
    from portbench.loops import decode
    from repro_torch import tracing

    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=device, t0=time.perf_counter(),
                          runner_class=None)
    config = cell.config
    op = config["ops"][0]
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    before = tracing.counters()
    # recording, so that the counts that wait for the card are made
    tracing.enable()
    for i in range(max(seeds, control_seeds)):
        server, weights, ids = decode.serve(ctx, seed + i)
        rows = decode.Rows(server, ids, op["dims"][2])
        kept = []
        for j in range(steps):
            pos = rows.step()
            if j in (0, steps - 1):
                kept.append(harness.Answer(
                    op["op"], (config["model"], weights, rows.fed(pos)),
                    rows.state.logits.clone()))
        del rows, server
        if i < seeds:
            for name, value in check.readings(kept, config).items():
                program.setdefault(name, []).append(value)
        if i < control_seeds:
            for name, value in check.readings(kept, config,
                                              against="control").items():
                control.setdefault(name, []).append(value)
        del kept, weights, ids
        tracing.collect()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    tracing.disable()
    tracing.collect()
    after = tracing.counters()
    counts = {name: after.get(name, 0) - before.get(name, 0)
              for name in ("moe.assignments", "moe.experts_read",
                           "moe.dropped")}
    return {"workload": cell.name, "seeds": [seed, seed + seeds - 1],
            "steps": steps, "program": program, "control": control,
            "counters": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(harness.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control_decode.py needs a CUDA card", file=sys.stderr)
        return 3
    out = readings(cell, args.seed, args.seeds, args.control_seeds,
                   args.steps, "cuda")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
