"""Quickstart for the PyTorch/CUDA port: tune one tensor program on the H100
and compare it against the baselines.

The paper's workflow in miniature (``examples/quickstart.py``'s loop):
  1. define a workload (an int8 QNN matmul, the paper's §IV-A op),
  2. run the probabilistic tuning loop, each candidate a CUDA kernel built
     and timed on the card (``CudaRunner`` on ``H100``),
  3. compare tuned vs hand-written-library schedule vs the library call
     (one PyTorch call, ``torch._int_mm`` + requantize),
  4. persist the best schedule to the tuning database (the deployable
     artifact — later runs dispatch through it with no search).

It needs a CUDA card and ``nvcc`` and does not fall back to the CPU without
one. ``--cpu`` asks for the CPU: the kernels' plain versions on the host
(``EmulateRunner`` on ``CPU_EMULATE``, wall-clock host numbers).

Run:  python examples/quickstart_torch.py [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (CPU_EMULATE, H100, CudaRunner,  # noqa: E402
                              EmulateRunner, TuningDatabase, baseline_latency,
                              fixed_library_schedule, tune)
from repro_torch.core import workload as W  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="measure the kernels' plain versions on the host "
                         "instead of the CUDA kernels on the card")
    args = ap.parse_args(argv)

    wl = W.qmatmul(64, 64, 128)  # int8 matmul + bias + requantize
    print(f"workload: {wl.key()}  ({wl.flops():.0f} flops)")

    if args.cpu:
        hw, runner, device = CPU_EMULATE, EmulateRunner(CPU_EMULATE), "cpu"
    else:
        hw, runner, device = H100, CudaRunner(H100), "cuda"  # raises w/o card
    db = TuningDatabase()

    print(f"\ntuning (32 trials, measured by {runner.name} on {hw.name}; "
          f"pipeline depth 2 —")
    print("generation N+1 evolves while generation N is on the card)...")
    res = tune(wl, hw, runner, trials=32, seed=0, database=db, log=print,
               pipeline_depth=2)

    fixed = fixed_library_schedule(wl, hw)
    t_fixed = runner.run(wl, fixed)
    t_lib = baseline_latency(wl, device=device)

    print(f"\ntuned    : {res.best_latency * 1e6:10.2f} us   "
          f"{res.best_schedule.as_dict()}")
    print(f"library  : {t_fixed * 1e6:10.2f} us   {fixed.as_dict()}")
    print(f"torch    : {t_lib * 1e6:10.2f} us   (one library call, "
          f"{'host wall clock' if args.cpu else 'CUDA events'})")
    print(f"\ntuned vs library: {t_fixed / res.best_latency:.2f}x")
    print(f"tuning cost: {res.wall_time_s / res.trials:.3f} s/candidate "
          f"({res.trials} candidates)")
    print(f"pipeline: {res.measure_time_s:.2f}s measuring, "
          f"{res.overlap_s:.2f}s of it hidden behind search "
          f"(overlap {res.overlap_fraction:.0%})")

    best = db.best(wl, hw.name)
    if best is None:
        raise RuntimeError("no schedule was recorded in the database")
    print(f"\ndatabase: best schedule persisted "
          f"({len(db)} records) -> dispatch is now search-free")


if __name__ == "__main__":
    main()
