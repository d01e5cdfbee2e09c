"""Whole-network passes on the tuned schedules, back to back: a closed loop
of one client that sends a request of one batch as soon as the last one
returned.

Set-up tunes the network with one ``TuningSession`` (its own database, the
mix's ``tune_seed``), resolves each op's schedule through
``dispatch.kernel_params``, builds it once with ``kernels.build`` and warms
the passes up. A pass runs every op of the network, ``count`` times, in
network order, each launch on its own operands, and ends in a synchronise:
the time a request that returns its result waits.

Passes cycle through as many sets of operands as make up at least
``rotate_bytes`` of operands and outputs, so that a network whose pass
fits in the card's L2 does not find its operands there from the pass
before: the kernels' rooflines hold against HBM.

The traffic file's keys: ``trials_per_workload`` (the session's budget),
``pipeline_depth``, ``warmup_passes``, ``trace_passes`` (passes profiled
before the window in a traced run), ``sample_passes`` (the range from which
one checked pass is drawn, beside the first and the last),
``rotate_bytes``, ``tune_seed`` (the session's seed: one for every run,
since the schedules it picks change the work a pass does, and the run's
seed draws the operands alone).
"""

from __future__ import annotations

import random
import time

from portbench import harness, inputs
from portbench import trace as tracing


def tune(ctx, traffic: dict):
    """The set-up session: one ``TuningSession`` over the network on a
    runner of its own, with a fresh database, at the mix's ``tune_seed``;
    returns (session result, database)."""
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.hardware import H100
    from repro_torch.core.session import TuningSession

    config = ctx.cell.config
    ops = [(o["count"], inputs.workload(o)) for o in config["ops"]]
    db = TuningDatabase()
    result = TuningSession(H100, ctx.runner_class(H100), database=db,
                           pipeline_depth=traffic["pipeline_depth"]
                           ).tune_model(
        ops, total_trials=traffic["trials_per_workload"]
        * len(inputs.unique(config)), seed=traffic["tune_seed"],
        model=config["name"])
    return result, db


def resolve(config: dict, db, device: str) -> tuple[dict, list]:
    """Each distinct op's built kernel, by (op, dims), and each op entry's
    (count, provenance)."""
    from repro_torch import kernels
    from repro_torch.core.dispatch import kernel_params
    from repro_torch.core.hardware import H100

    built, provenance = {}, []
    for op in config["ops"]:
        key = (op["op"], tuple(op["dims"]))
        wl = inputs.workload(op)
        params, prov = kernel_params(wl, H100, database=db, count=op["count"])
        provenance.append((op["count"], prov))
        if key not in built:
            built[key] = kernels.build(wl, params, device=device)
    return built, provenance


def run(ctx) -> harness.Run:
    import torch

    config, traffic = ctx.cell.config, ctx.cell.traffic
    sets = inputs.rotation(config, ctx.seed, ctx.device,
                           traffic["rotate_bytes"])
    result, db = tune(ctx, traffic)
    built, provenance = resolve(config, db, ctx.device)
    fns = [built[(op["op"], tuple(op["dims"]))]
           for op in inputs.expand(config)]
    launches = [list(zip(fns, launches_in)) for launches_in in sets]

    def one_pass(i):
        outs = [fn(*args) for fn, args in launches[i % len(launches)]]
        ctx.sync()
        return outs

    # The window keeps the outputs of its first pass and of one drawn from
    # the seed: warm-up holds two passes' outputs as well, so that the
    # allocator has the blocks of four passes cached before the window
    # and allocates nothing on the card inside it.
    held = []
    for i in range(max(traffic["warmup_passes"], len(sets), 4)):
        outs = one_pass(i)
        if len(held) < 2:
            held.append(outs)
    del held, outs
    facts = {"session": result, "provenance": provenance,
             "operand_sets": len(sets)}
    trace = None
    if ctx.trace:
        holder: dict = {}
        n = traffic["trace_passes"]
        with tracing.traced(ctx, holder):
            for i in range(n):
                with torch.profiler.record_function("portbench.pass"):
                    one_pass(i)
        trace = holder["trace"]
        facts["passes_traced"] = n

    ctx.setup_done()
    sample = random.Random(ctx.seed).randrange(1, traffic["sample_passes"])
    kept, latencies = [], []
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        i = len(latencies)
        t0 = time.perf_counter()
        outs = one_pass(i)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if i in (0, sample):
            kept.append((i, outs))
        if t1 >= end:
            break
    kept.append((i, outs))
    window_s = t1 - start
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    passes = len(latencies)
    # the program's state goes before the reference runs
    del launches, built, fns, db, one_pass
    answers = [harness.Answer(op["op"], args, out)
               for i, outs in kept
               for op, args, out in zip(inputs.expand(config),
                                        sets[i % len(sets)], outs)]
    expected = len(kept) * len(sets[0])
    lat = sorted(latencies)
    e2e = {"infer_ms": window_s / passes * 1e3,
           "infer_p95_ms": percentile(lat, 95) * 1e3}
    return harness.Run(attempted=passes, end_to_end=e2e, answers=answers,
                       expected_answers=expected, memory_peak_bytes=peak,
                       trace=trace, facts=facts)


def percentile(sorted_values: list[float], q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    pos = (len(sorted_values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) \
        * (pos - lo)
