"""Batched-serving example for the PyTorch/CUDA port
(``examples/serve_lm.py``'s flow): prefill a batch of prompts, decode
greedily, report prefill latency and decode throughput. Exercises the same
prefill and decode functions the dry run traces as ``serve_step``.

With ``--continuous-tune`` the example also demonstrates the
serving↔tuning loop synchronously and in-process: the first generate
dispatches every decode workload through the fixed library (cold
database) while recording the misses, one ContinuousTuner cycle tunes the
recorded shapes against the shared in-memory database, and the second
generate resolves them with "tuned" provenance — no restart, no files.

The model runs on the card, and the tuner measures each candidate as a
CUDA kernel on the H100 (``CudaRunner``); without a card it raises.
``--cpu`` serves on the CPU and tunes the kernels' plain versions on the
host (``EmulateRunner`` on ``CPU_EMULATE``).

Run:  python examples/serve_lm_torch.py [--arch mamba2_780m] [--cpu]
      python examples/serve_lm_torch.py --continuous-tune
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import (CPU_EMULATE, H100,  # noqa: E402
                              ContinuousTuner, EmulateRunner, TrafficLog,
                              TuningDatabase)
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.runtime.serve_loop import Server, decode_ops  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3_1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-steps", type=int, default=32)
    ap.add_argument("--continuous-tune", action="store_true",
                    help="demo the miss-record -> tune -> re-dispatch loop")
    ap.add_argument("--tune-trials", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="serve and tune on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to serve on the CPU")

    cfg = get_config(args.arch).reduced()
    bundle = build(cfg, remat="none", device=device)
    params = bundle.init(torch.Generator().manual_seed(0))

    hw = serve_ops = traffic = database = runner = None
    if args.continuous_tune:
        hw = CPU_EMULATE if args.cpu else H100
        runner = EmulateRunner(hw) if args.cpu else None  # None: CudaRunner
        serve_ops = decode_ops(cfg, args.batch)
        traffic = TrafficLog()
        database = TuningDatabase()  # in-memory, shared with the tuner
    server = Server(bundle, params,
                    max_len=args.prompt_len + args.gen_steps + 1,
                    hw=hw, serve_ops=serve_ops, traffic=traffic,
                    database=database)

    batch = bundle.make_batch(
        7, ShapeSpec("serve", args.prompt_len, args.batch, "decode"),
        train=False)
    prompts = np.asarray(batch.pop("tokens"))
    res = server.generate(prompts, args.gen_steps,
                          extra_batch=batch or None)

    tok_s = args.batch * args.gen_steps / max(res.decode_s, 1e-9)
    print(f"arch={cfg.name} ({cfg.family}) batch={args.batch} "
          f"device={device}")
    print(f"prefill({args.prompt_len} tok): {res.prefill_s * 1e3:8.1f} ms")
    print(f"decode ({args.gen_steps} steps): {res.decode_s * 1e3:8.1f} ms "
          f"= {tok_s:.1f} tok/s")
    for row in res.tokens[:2]:
        print("  gen:", row[args.prompt_len:args.prompt_len + 12].tolist())

    if args.continuous_tune:
        def mix(d):
            return " ".join(f"{k}={v}" for k, v in sorted(d.items()))

        print(f"cold dispatch: {mix(res.dispatch)} "
              f"({traffic.pending(hw.name)} miss shape(s) recorded)")
        tuner = ContinuousTuner(traffic, hw, runner=runner,
                                database=database,
                                trials_per_shape=args.tune_trials,
                                max_shapes_per_cycle=len(serve_ops))
        tuner.tune_once()
        res = server.generate(prompts, args.gen_steps,
                              extra_batch=batch or None)
        print(f"after {tuner.shapes_tuned}-shape tuning cycle: "
              f"{mix(res.dispatch)}")


if __name__ == "__main__":
    main()
