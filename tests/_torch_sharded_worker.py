"""The ranks of tests/test_torch_sharded_train.py: four spawned processes
on a gloo 2x2 ("data", "model") mesh. Spawned workers import this module
by name, so it imports torch and the port only (not JAX).

Rank 0 writes what the ranks computed (full values, numpy) to
``<out>/result.pt``; the test holds it against the reference. Last, the
same four ranks as one (1, 4) row run a step whose model axis does not
divide the KV heads, then one whose model axis divides neither head count,
each held against the unsharded step.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

SEQ, BATCH = 16, 4
STEPS = {"granite_3_2b": 2, "qwen2_moe_a2_7b": 1}


# (arch, with param_gather_specs): the dense family without and with the
# ZeRO-3 gather, then the MoE family
CASES = (("granite_3_2b", False), ("granite_3_2b", True),
         ("qwen2_moe_a2_7b", False))


def _numpy(tree):
    """A nested dict of full values as numpy arrays (every rank gathers a
    DTensor leaf)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim.tree import param_tree

    tree = param_tree(tree)
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().numpy()


def _train(arch, weights, opt_cfg, mesh, gather: bool):
    """``STEPS[arch]`` steps of ``jit_train_step`` from ``weights`` on
    ``make_batch``'s batches (seeds 0, 1, ...: the reference's): the
    metrics of each step, the final state (full values), whether the
    ZeRO-3 gather's gradients came back in the storage placements, and
    the state and its shardings."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build, from_numpy_params
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.train_loop import (gather_params,
                                                jit_train_step,
                                                make_train_step)

    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = from_numpy_params(cfg, weights, "cpu")
    state = {"params": params, "opt": adamw.init(params)}
    specs = None
    if gather:
        specs = tree_map(lambda s: tuple(None if a == "data" else a
                                         for a in s),
                         sh.param_specs(params, mesh))
    batches = [bundle.make_batch(i, ShapeSpec("t", SEQ, BATCH, "train"))
               for i in range(STEPS[arch])]
    step, state_sh, _ = jit_train_step(
        make_train_step(bundle, opt_cfg, param_gather_specs=specs), state,
        mesh, {k: v.ndim for k, v in batches[0].items()})
    grads_in_storage = None
    if gather:
        batch = {k: sh.token_sharding(mesh, v.ndim).place(torch.as_tensor(v))
                 for k, v in batches[0].items()}
        with implicit_replication():
            loss = bundle.loss_fn(gather_params(state["params"], specs),
                                  batch)
            grads = torch.autograd.grad(loss, leaves(state["params"]))
        grads_in_storage = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(grads, leaves(state["params"]), strict=True))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    result = {"metrics": metrics, "grads_in_storage": grads_in_storage,
              "params": _numpy(state["params"]),
              "m": _numpy(state["opt"]["m"]), "v": _numpy(state["opt"]["v"]),
              "step": int(state["opt"]["step"].full_tensor())}
    return result, state, state_sh


def _uneven_heads(cfg, weights, opt_cfg) -> dict:
    """One ``jit_train_step`` of ``cfg`` (a ``granite_3_2b.reduced()``) on
    the four ranks laid out as one (1, 4) ("data", "model") row, where the
    model axis does not divide the KV heads (and, with 6 query heads, not
    the query heads either: the query rows split), against the unsharded
    step from the same weights and batch."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build, from_numpy_params
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime.train_loop import jit_train_step, make_train_step

    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    L.set_activation_sharding(("data",), 1, "model", 4)
    bundle = build(cfg, remat="none", device="cpu")
    batch = bundle.make_batch(0, ShapeSpec("t", SEQ, BATCH, "train"))
    states = []
    for _ in range(2):
        params = from_numpy_params(cfg, weights, "cpu")
        states.append({"params": params, "opt": adamw.init(params)})
    plain, m0 = make_train_step(bundle, opt_cfg)(states[0], batch)
    step, _, _ = jit_train_step(make_train_step(bundle, opt_cfg), states[1],
                                mesh, {k: v.ndim for k, v in batch.items()})
    sharded, m1 = step(states[1], batch)
    # Adam's first update is ill conditioned where sqrt(vhat) is under 100
    # eps: there gradients that agree within 1e-8 give updates apart by up
    # to lr (tests/test_torch_sharded_train.py's _check_leaf)
    well, ill = [], []
    for a, b, v in zip(leaves(plain["params"]), leaves(sharded["params"]),
                       leaves(plain["opt"]["v"]), strict=True):
        diff = (a.detach() - b.full_tensor().detach()).abs()
        cond = (v / (1 - opt_cfg.b2)).sqrt() <= 100 * opt_cfg.eps
        well.append(float(diff[~cond].max()) if (~cond).any() else 0.0)
        ill.append(float(diff[cond].max()) if cond.any() else 0.0)
    return {"kv_heads": cfg.n_kv_heads, "q_heads": cfg.n_heads,
            "loss": float(m0["loss"]), "sharded_loss": float(m1["loss"]),
            "grad_norm": float(m0["grad_norm"]),
            "sharded_grad_norm": float(m1["grad_norm"]),
            "max_param_diff": max(well), "max_ill_param_diff": max(ill)}


def run(rank: int, world: int, store_path: str, out: str, weights: dict,
        opt_cfg, seeds) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.models import layers as L
        from repro_torch.models.model_zoo import build, from_numpy_params
        from repro_torch.optim import adamw, compression
        from repro_torch.optim.tree import leaves, nest
        from repro_torch.runtime import sharding as sh

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        L.set_activation_sharding(sh.batch_axes(mesh), 2, "model", 2)
        res, states = {}, {}
        for arch, gather in CASES:
            res[arch, gather], *states[arch, gather] = _train(
                arch, weights[arch], opt_cfg, mesh, gather)

        # elastic restore: granite's state saved under 2x2, restored onto
        # 2x2 into a fresh unplaced state (the test restores it onto one
        # device)
        state, state_sh = states["granite_3_2b", False]
        CheckpointManager(os.path.join(out, "ckpt")).save(1, state)
        cfg = get_config("granite_3_2b").reduced()
        fresh = from_numpy_params(cfg, weights["granite_3_2b"], "cpu")
        _, restored, _ = CheckpointManager(os.path.join(out, "ckpt")).restore(
            {"params": fresh, "opt": adamw.init(fresh)}, shardings=state_sh)
        res["restored"] = {
            "params": _numpy(restored["params"]),
            "m": _numpy(restored["opt"]["m"]),
            "step": int(restored["opt"]["step"].full_tensor()),
            "placements_kept": all(
                tuple(a.placements) == tuple(b.placements)
                for a, b in zip(leaves(restored["params"]),
                                leaves(state["params"]), strict=True))}

        # compressed_all_reduce over the four ranks
        out_ar = {}
        for seed, dtype in seeds:
            rng = np.random.default_rng(seed + rank)
            x = (rng.standard_normal((16, 24)) * 3).astype(np.float32)
            got = compression.compressed_all_reduce(
                torch.tensor(x).to(getattr(torch, dtype)))
            out_ar[seed, dtype] = (str(got.dtype), got.float().numpy())
        gathered = [None] * world
        dist.all_gather_object(gathered, out_ar)
        res["all_reduce"] = gathered
        cfg = get_config("granite_3_2b").reduced()
        res["uneven_heads"] = _uneven_heads(cfg, weights["granite_3_2b"],
                                            opt_cfg)
        # six query heads: the (1, 4) model axis splits the query rows
        cfg = dataclasses.replace(cfg, n_heads=6)
        drawn = build(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        res["row_split"] = _uneven_heads(
            cfg, nest({n: p.detach().numpy()
                       for n, p in drawn.named_parameters()}), opt_cfg)
        L.clear_activation_sharding()
        if rank == 0:
            torch.save(res, os.path.join(out, "result.pt"))
    finally:
        dist.destroy_process_group()
