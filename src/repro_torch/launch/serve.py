"""Serving launcher: batched prefill+decode for any architecture of the
model pool at its reduced size (the JAX package's ``launch/serve.py``,
ported). The encoder-decoder family's stub frames ride in the batch beside
the prompts.

With ``--continuous-tune`` the launcher closes the serving↔tuning loop the
way a production deployment would: the server resolves each decode step's
workloads through the dispatch chain, records misses into a
:class:`~repro_torch.core.traffic.TrafficLog`, a background
:class:`~repro_torch.core.traffic.ContinuousTuner` tunes the hottest shapes
for the H100 (``CudaRunner`` on the card) and saves the artifact, and the
hot-swapping ``global_database()`` flips later rounds' dispatch to
``"tuned"`` — same process, no restart. With ``--device cpu`` the tuner
measures the kernels' plain versions on the host instead (``EmulateRunner``
on ``CPU_EMULATE``).

Run:  python -m repro_torch.launch.serve --continuous-tune --rounds 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import (CPU_EMULATE, H100, ContinuousTuner,
                              EmulateRunner, TrafficLog, default_db_path,
                              reset_global_database)
from repro_torch.models.model_zoo import build
from repro_torch.runtime.serve_loop import Server, decode_ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi_6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (and, with --continuous-tune, "
                         "where candidates are measured)")
    ap.add_argument("--continuous-tune", action="store_true",
                    help="record dispatch misses and background-tune the "
                         "hottest shapes; the server hot-swaps the tuned "
                         "artifact between rounds")
    ap.add_argument("--rounds", type=int, default=3,
                    help="traffic rounds to serve in continuous-tune mode")
    ap.add_argument("--tune-db", default=None,
                    help="tuned-artifact path (default: REPRO_TUNING_DB "
                         "or tuned/database.json)")
    ap.add_argument("--tune-trials", type=int, default=16,
                    help="search trials per traffic shape per cycle")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    bundle = build(cfg, remat="none", device=args.device)
    params = bundle.init(torch.Generator().manual_seed(args.seed))

    hw = serve_ops = traffic = tuner = None
    if args.continuous_tune:
        if args.tune_db:
            os.environ["REPRO_TUNING_DB"] = args.tune_db
        reset_global_database()
        on_card = args.device == "cuda"
        hw = H100 if on_card else CPU_EMULATE
        serve_ops = decode_ops(cfg, args.batch)
        traffic = TrafficLog()
        tuner = ContinuousTuner(traffic, hw,
                                runner=None if on_card else EmulateRunner(hw),
                                db_path=default_db_path(),
                                trials_per_shape=args.tune_trials,
                                max_shapes_per_cycle=len(serve_ops),
                                seed=args.seed).start()

    server = Server(bundle, params,
                    max_len=args.prompt_len + args.gen_steps + 1,
                    hw=hw, serve_ops=serve_ops, traffic=traffic)
    batch = bundle.make_batch(
        args.seed, ShapeSpec("serve", args.prompt_len, args.batch, "decode"),
        train=False)
    prompts = np.asarray(batch.pop("tokens"))

    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen_steps} device={args.device}")
    rounds = args.rounds if args.continuous_tune else 1
    res = None
    try:
        for rnd in range(rounds):
            res = server.generate(prompts, args.gen_steps,
                                  extra_batch=batch or None)
            tok_s = args.batch * args.gen_steps / max(res.decode_s, 1e-9)
            line = (f"prefill {res.prefill_s * 1e3:.1f} ms; decode "
                    f"{res.decode_s * 1e3:.1f} ms ({tok_s:.1f} tok/s)")
            if res.dispatch is not None:
                mix = " ".join(f"{k}={v}"
                               for k, v in sorted(res.dispatch.items()))
                line += f"; dispatch: {mix}"
            print(f"round {rnd}: {line}" if rounds > 1 else line)
            if tuner is not None:
                tuner.wait_idle(timeout=300.0)  # let the cycle land first
    finally:
        if tuner is not None:
            tuner.stop()
    if tuner is not None:
        print(f"continuous tuning: {tuner.cycles} cycle(s), "
              f"{tuner.shapes_tuned} shape(s) -> {tuner.database.path}")
    print("sample:", res.tokens[0, : args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
