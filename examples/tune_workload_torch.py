"""The paper's end-to-end deployment flow on a complete network, for the
PyTorch/CUDA port (``examples/tune_workload.py``'s flow): extract
per-operator workloads from BERT-tiny int8 (the paper's NLP benchmark,
``repro_torch.nets``) and tune them as one TuningSession — unique
workloads deduped, searches warm-started from any existing database
records, one shared trial budget — then report the network-level latency
against the hand-written library mapping: Figure 7's experiment.

On the card each candidate is a CUDA kernel built and timed on the H100
(``CudaRunner``); without a card it raises rather than fall back.
``--cpu`` runs the JAX package's own configuration instead, the analytic
TPU v5e model (``AnalyticRunner(V5E)``), whose table equals that
example's line for line.

Run:  python examples/tune_workload_torch.py [--cpu] [--trials 32]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import nets  # noqa: E402
from repro_torch.core import (H100, V5E, AnalyticRunner,  # noqa: E402
                              CudaRunner, TuningDatabase, TuningSession)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the analytic v5e model on the host (the JAX "
                         "package's example) instead of the card")
    ap.add_argument("--trials", type=int, default=32,
                    help="trials per operator of the network")
    args = ap.parse_args(argv)

    ops = nets.bert_tiny(dtype="int8")
    if args.cpu:
        hw, runner = V5E, AnalyticRunner(V5E)
    else:
        hw, runner = H100, CudaRunner(H100)  # raises without a card
    db = TuningDatabase()
    session = TuningSession(hw, runner, database=db, log=print)
    result = session.tune_model(ops, total_trials=args.trials * len(ops),
                                seed=0)

    print(f"\n{'operator':44s} {'tuned':>10s} {'library':>10s}  speedup")
    for rep in result.reports:
        print(f"{rep.workload.key():44s} {rep.best_latency * 1e6:9.2f}us "
              f"{rep.fixed_latency * 1e6:9.2f}us  "
              f"{rep.speedup_vs_fixed:6.2f}x  (x{rep.count})")

    t_tuned, t_fixed = result.tuned_latency, result.fixed_latency
    print(f"\nbert-tiny total: tuned {t_tuned * 1e6:.1f} us, "
          f"library {t_fixed * 1e6:.1f} us "
          f"-> {(1 - t_tuned / t_fixed) * 100:.0f}% latency improvement")
    # The analytic runner measures instantaneously, so that session runs
    # serially; on the card (CudaRunner, overlap-capable) the session
    # interleaves one workload's measurement with another's evolution and
    # reports the hidden fraction here.
    print(f"session wall time: {result.wall_time_s:.1f}s "
          f"(interleaved={result.interleaved}, "
          f"overlap {result.overlap_fraction:.0%})")
    print(f"database records: {len(db)}, session summaries: "
          f"{len(db.sessions)}")


if __name__ == "__main__":
    main()
