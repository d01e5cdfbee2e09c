#!/usr/bin/env python3
"""The sharded train step of the families tier-1 does not hold (SSM,
hybrid, encoder-decoder; the test file holds the dense and MoE ones): four
CPU processes on a gloo 2x2 ("data", "model") mesh run one
``jit_train_step`` of each at ``reduced()`` in f32, and the loss, grad norm
and new parameters are compared with the unsharded step from the same
weights and ``make_batch`` batch.

Prints one JSON line per family (the differences, the first step's
seconds on rank 0) and exits 1 if a loss or grad norm is off rtol 1e-4 /
atol 1e-5. About 30 s: DTensor's first-step sharding propagation
takes 1-4 s a family in each rank.

Run:  python tools/sharded_families_check.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

ARCHS = ("mamba2_780m", "recurrentgemma_2b", "whisper_tiny")
SEQ, BATCH = 16, 4


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.models import layers as L
        from repro_torch.models.model_zoo import build
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.optim.tree import leaves
        from repro_torch.runtime import sharding as sh
        from repro_torch.runtime.train_loop import (init_train_state,
                                                    jit_train_step,
                                                    make_train_step)

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        L.set_activation_sharding(sh.batch_axes(mesh), 2, "model", 2)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        lines = []
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            bundle = build(cfg, remat="none", device="cpu")
            batch = bundle.make_batch(0, ShapeSpec("t", SEQ, BATCH, "train"))
            states = [init_train_state(bundle,
                                       torch.Generator().manual_seed(0), opt)
                      for _ in range(2)]
            plain, m0 = make_train_step(bundle, opt)(states[0], batch)
            step, _, _ = jit_train_step(make_train_step(bundle, opt),
                                        states[1], mesh,
                                        {k: v.ndim for k, v in batch.items()})
            t0 = time.perf_counter()
            sharded, m1 = step(states[1], batch)
            seconds = time.perf_counter() - t0
            param_diff = max(
                float((a.detach() - b.full_tensor().detach()).abs().max())
                for a, b in zip(leaves(plain["params"]),
                                leaves(sharded["params"]), strict=True))
            lines.append({
                "arch": arch, "family": cfg.family,
                "loss": float(m0["loss"]), "sharded_loss": float(m1["loss"]),
                "grad_norm": float(m0["grad_norm"]),
                "sharded_grad_norm": float(m1["grad_norm"]),
                "max_param_diff": param_diff, "first_step_s": seconds})
        L.clear_activation_sharding()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(lines, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import math

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        mp.start_processes(_rank, args=(4, os.path.join(tmp, "store"), out),
                           nprocs=4, join=True, start_method="spawn")
        with open(out) as f:
            lines = json.load(f)
    ok = True
    for line in lines:
        print(json.dumps(line))
        ok &= all(math.isclose(line[f"sharded_{k}"], line[k], rel_tol=1e-4,
                               abs_tol=1e-5) for k in ("loss", "grad_norm"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
