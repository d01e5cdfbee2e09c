"""Where a cell's set-up and its passes hold the host, from the program's own
spans (``repro_torch.tracing``): what lies behind ``setup_s``, ``tune_s``,
``search_ms_per_trial`` and ``measure_ms_per_trial``, and behind the traced
window's ``idle_share``.

    python3 portbench/spans.py --workload <cell> --seed <n> \
        [--blocks 4] [--block-passes 25]

Runs the cell's set-up as ``loops/passes.py`` does, with the tracer on, and
prints it by named parts (imports, CUDA context, operands, the tuning
session, resolve, warm-up), then the session's spans by name and thread,
each with its thread's CPU time where the span reads it (the rest is time
the thread did not run: waiting for the interpreter lock, or blocked).
Then it profiles ``--blocks`` pairs of blocks of passes, the tracer off in
one block of a pair and on in the other, in turns, and prints each half's
idle share of the card and time a pass, and, where the tracer was on, the
host's time in each ``<op>.call`` and ``<op>.launch`` span, the card's
idle inside them, and the idle gap at each pass's start and how it splits.
The last line of standard output is the whole report as JSON. It needs a
CUDA card; its functions also run the tests' tiny cell on the CPU.

:func:`trials` gives the readers of ``search_ms_per_trial`` and
``measure_ms_per_trial`` the program's ``tuner.trials`` counter.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

# The wrappers' spans around one call of a built op (``kernels/*/ops.py``)
# and around its ``ctypes`` launch (``kernels/*/kernel.py``).
OPS = ("matmul", "qmatmul", "gemv", "vmacc", "attention")
CALLS = tuple(op + ".call" for op in OPS)
LAUNCHES = tuple(op + ".launch" for op in OPS)


def trials() -> int | None:
    """Candidates the process's tuning sessions reconciled (the program's
    counter ``tuner.trials``; a benchmark run holds one session, the
    set-up's); None from a program without the tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get("tuner.trials")


def merged(intervals) -> list[list[int]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def overlap_ns(xs, ys) -> int:
    """The length of the intersection of two unions of intervals."""
    xs, ys = merged(xs), merged(ys)
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def by_name(spans, main_thread: int) -> dict:
    """Each span name's count, summed length and summed CPU time (s; None
    where its spans read none), keyed "<thread>: <name>", the thread
    "main" (the caller's) or "other"."""
    out: dict[str, dict] = {}
    for s in spans:
        key = ("main" if s.thread == main_thread else "other") + ": " + s.name
        row = out.setdefault(key, {"n": 0, "s": 0.0, "cpu_s": None})
        row["n"] += 1
        row["s"] += (s.end_ns - s.start_ns) / 1e9
        if s.cpu_ns is not None:
            row["cpu_s"] = (row["cpu_s"] or 0.0) + s.cpu_ns / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))


def setup(ctx) -> tuple[dict, list]:
    """The cell's set-up as ``loops/passes.py`` runs it, the tracer on:
    ({"parts": seconds by part, "session": the session's spans by name,
    "trials": ...}, each operand set's (fn, args) launches)."""
    import torch

    from portbench import inputs
    from portbench.loops import passes
    from repro_torch import tracing

    config, traffic = ctx.cell.config, ctx.cell.traffic
    parts, t = {}, time.perf_counter()

    def part(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    tracing.reset_counters("tuner.")
    tracing.collect()
    tracing.enable()
    try:
        if ctx.device == "cuda":
            torch.cuda.init()
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        part("cuda_context")
        sets = inputs.rotation(config, ctx.seed, ctx.device,
                               traffic["rotate_bytes"])
        part("operands")
        result, db = passes.tune(ctx, traffic)
        part("session")
        session = tracing.collect()
        built, _ = passes.resolve(config, db, ctx.device)
        part("resolve")
        fns = [built[(op["op"], tuple(op["dims"]))]
               for op in inputs.expand(config)]
        launches = [list(zip(fns, launch_args)) for launch_args in sets]
        for i in range(max(traffic["warmup_passes"], len(sets), 4)):
            one_pass(ctx, launches, i)
        part("warm_up")
    finally:
        tracing.disable()
    rest = tracing.collect()
    report = {"parts": parts,
              "session": by_name(session, threading.get_ident()),
              "resolve_and_warm_up": by_name(rest, threading.get_ident()),
              "trials": tracing.counters().get("tuner.trials", 0),
              "session_wall_s": result.wall_time_s,
              "search_time_s": result.search_time_s,
              "measure_time_s": result.measure_time_s}
    return report, launches


def one_pass(ctx, launches, i):
    outs = [fn(*args) for fn, args in launches[i % len(launches)]]
    ctx.sync()
    return outs


def block(ctx, launches, passes: int, record: bool) -> dict:
    """``passes`` passes profiled as one traced window, the tracer on if
    ``record``: the card's idle share and ms a pass, and where recorded the
    wrappers' spans set against the card's idle gaps."""
    from portbench import trace
    from repro_torch import tracing

    holder: dict = {}
    starts = []
    tracing.collect()
    if record:
        tracing.enable()
    try:
        with trace.traced(ctx, holder):
            for i in range(passes):
                starts.append(time.time_ns())
                one_pass(ctx, launches, i)
    finally:
        tracing.disable()
    spans = tracing.collect()
    window = holder["trace"]
    gaps = window.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    out = {"idle_pct": 100.0 * idle / 1e9 / window.window_s,
           "ms_per_pass": 1e3 * window.window_s / passes}
    if not record:
        return out
    calls = [(s.start_ns, s.end_ns) for s in spans if s.name in CALLS]
    launched = [(s.start_ns, s.end_ns) for s in spans if s.name in LAUNCHES]
    # the idle gap each pass starts in: the last pass's synchronise to the
    # pass's first operation on the card
    first = [next(((a, b) for a, b in gaps if a <= t < b), None)
             for t in starts]
    first = [g for g in first if g is not None]
    n = max(1, len(first))
    out.update(
        calls=len(calls),
        launch_host_us=(sum(b - a for a, b in calls) / len(calls) / 1e3
                        if calls else None),
        launch_span_us=(sum(b - a for a, b in launched) / len(launched)
                        / 1e3 if launched else None),
        idle_in_call_pct=100.0 * overlap_ns(gaps, calls) / 1e9
        / window.window_s,
        idle_in_launch_pct=100.0 * overlap_ns(gaps, launched) / 1e9
        / window.window_s,
        pass_start_gap_ms=sum(b - a for a, b in first) / n / 1e6,
        pass_start_in_call_ms=overlap_ns(first, calls) / n / 1e6,
        pass_start_in_launch_ms=overlap_ns(first, launched) / n / 1e6)
    return out


def passes_split(ctx, launches, blocks: int, block_passes: int) -> dict:
    """``blocks`` pairs of :func:`block`, recorded and not in turns (which
    goes first alternates); each key's median over the pairs, by half."""
    halves: dict[str, list[dict]] = {"off": [], "on": []}
    for b in range(blocks):
        for record in ((False, True) if b % 2 == 0 else (True, False)):
            halves["on" if record else "off"].append(
                block(ctx, launches, block_passes, record))
    return {half: {key: statistics.median(r[key] for r in rows)
                   for key in rows[0] if rows[0][key] is not None}
            for half, rows in halves.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--block-passes", type=int, default=25)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from repro_torch.core.runner import CudaRunner

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    imports_s = time.perf_counter() - T0
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=0.0, trace=True,
                          device="cuda", t0=T0, runner_class=CudaRunner)
    report, launches = setup(ctx)
    report["parts"] = {"imports": imports_s, **report["parts"]}
    report["setup_s"] = time.perf_counter() - T0
    report["passes"] = passes_split(ctx, launches, args.blocks,
                                    args.block_passes)
    report["device"] = torch.cuda.get_device_name(0)
    total = report["setup_s"]
    print(f"{cell.name}: set-up {total:.3f} s")
    for name, s in report["parts"].items():
        print(f"  {name:14s} {s:9.3f} s  {100 * s / total:5.1f} %")
    for title in ("session", "resolve_and_warm_up"):
        print(f"  {title}, spans by thread and name (s; CPU s):")
        for name, row in report[title].items():
            cpu = "" if row["cpu_s"] is None else f"  cpu {row['cpu_s']:.3f}"
            print(f"    {name:40s} {row['n']:6d} {row['s']:9.3f}{cpu}")
    for half, row in report["passes"].items():
        print(f"  passes, tracer {half}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in row.items()))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main())
