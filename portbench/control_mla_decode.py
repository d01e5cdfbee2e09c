"""The readings the limit of the ``mla_decode`` cell's comparison is set
from, at the cell's own sizes, in one process (``control_decode.py`` serves
the ``decode`` cells):

- the program's: on each seed's weights and prompts, the ``Server``'s
  prefill and ``--steps`` decode steps, as the ``mla_decode`` loop's set-up
  runs them; the first and the last step's logits compared with the
  reference's;
- the control's: the reference one precision below the configuration's
  (float8 e4m3 at every matmul input, ``reference/<op>.py``'s
  ``control``) on the same weights and tokens, compared with the
  reference's;
- the program's choices at each checked position against the reference's
  own: the share outside the reference's top-k, answer by answer (the
  reference's ``MAX_DISAGREE`` bounds it);
- the share of the experts the correction bias moved: of the experts the
  decode-step MoE kernel chose in the program's steps, those outside the
  top-k of the unbiased scores of its own logits.

    python3 portbench/control_mla_decode.py \
        --workload moonlight-16b-a3b-b16.mla_decode --seed 7 --seeds 6 \
        --control-seeds 3

Prints one JSON line: each number's readings, seed by seed, for both, the
bias's share and the program's MoE counters over all its steps. A limit
lies above the program's largest reading and below the control's smallest.
Needs a card, as the benchmark does.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


@contextlib.contextmanager
def bias_moves(moved: list):
    """While open, each call of the decode-step MoE kernel appends (experts
    chosen, of them outside the unbiased top-k) to ``moved``."""
    import torch
    from repro_torch.kernels.moe_decode import kernel

    real = kernel.moe_decode

    def counted(*args, **kwargs):
        y, routing = real(*args, **kwargs)
        k = routing.sel.shape[1]
        plain = torch.topk(torch.sigmoid(routing.logits), k, dim=-1)[1]
        chosen = routing.sel.long()
        kept = (chosen[:, :, None] == plain[:, None, :]).any(-1)
        moved.append((chosen.numel(), int((~kept).sum())))
        return y, routing

    kernel.moe_decode = counted
    try:
        yield
    finally:
        kernel.moe_decode = real


def readings(cell, seed: int, seeds: int, control_seeds: int, steps: int,
             device: str) -> dict:
    import gc

    import torch
    from portbench import check, harness
    from portbench.loops import decode, mla_decode
    from portbench.reference import family
    from repro_torch import tracing

    fam = family(cell.config["ops"][0]["op"])

    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=device, t0=time.perf_counter(),
                          runner_class=None)
    config = cell.config
    op = config["ops"][0]
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    moved: list = []
    shares: list = []
    before = tracing.counters()
    # recording, so that the steps run eagerly and the counts that wait for
    # the card are made
    tracing.enable()
    for i in range(max(seeds, control_seeds)):
        server, weights, ids = mla_decode.serve(ctx, seed + i)
        rows = decode.Rows(server, ids, op["dims"][2])
        kept = []
        with bias_moves(moved):
            for j in range(steps):
                pos = rows.step()
                if j in (0, steps - 1):
                    kept.append(harness.Answer(
                        op["op"], (config["model"], weights, rows.fed(pos),
                                   rows.state.cache["experts"].clone()),
                        rows.state.logits.clone()))
        del rows, server
        if i < seeds:
            for name, value in check.readings(kept, config).items():
                program.setdefault(name, []).append(value)
            for answer in kept:
                found: list = []
                fam.logits_at_last(*answer.inputs[:3],
                                   experts=answer.inputs[3], found=found)
                shares.append(fam.disagree(found, answer.inputs[3]))
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
                           "moe.dropped", "launch._mla_decode",
                           "launch._moe_decode")}
    chosen = sum(n for n, _ in moved)
    return {"workload": cell.name, "seeds": [seed, seed + seeds - 1],
            "steps": steps, "program": program, "control": control,
            "bias_moved_share": sum(m for _, m in moved) / max(chosen, 1),
            "bias_chosen": chosen, "disagree": shares,
            "max_disagree": fam.MAX_DISAGREE, "counters": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(harness.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control_mla_decode.py needs a CUDA card", file=sys.stderr)
        return 3
    out = readings(cell, args.seed, args.seeds, args.control_seeds,
                   args.steps, "cuda")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
