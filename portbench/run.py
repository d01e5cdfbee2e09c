"""The port's benchmark: one cell of ``BENCHMARK.json``, one process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output (the end-to-end metrics with ``--trace 0``,
the per-layer ones with ``--trace 1``). It needs as many CUDA cards as the
cell asks for, and exits non-zero with no result without them, or when
the process holds JAX or the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(harness.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    from repro_torch.core.runner import CudaRunner

    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", t0=T0,
                          runner_class=CudaRunner)
    line, err = harness.execute(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(err), file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
