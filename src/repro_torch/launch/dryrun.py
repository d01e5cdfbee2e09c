"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on the
production meshes, in one process, with no memory drawn (the JAX
package's ``launch/dryrun.py``, ported).

The reference's first two lines force 512 placeholder host devices so that
``make_production_mesh`` can build the 16x16 and 2x16x16 meshes. Their
counterpart here is a ``"fake"`` process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, moving nothing), which :func:`run_cell` starts before it
calls ``make_production_mesh(device="cpu")`` and destroys after the cell.
The process is rank 0; the layouts are uniform, so its shards are what
every device holds.

Per cell this script:
  1. builds the state on the meta device (shapes and dtypes, no memory:
     the counterpart of ``jax.eval_shape``), lays it out FSDP x TP as
     DTensors with meta local shards, and builds the train, prefill or
     decode step;
  2. runs the step once under :func:`op_analysis.analyze` (the counterpart
     of lowering, compiling and ``hlo_analysis``): per-device flops,
     bytes, collective bytes by op, the op census, and the live-storage
     counter's memory (arguments, outputs, the high-water mark of what
     the step allocates);
  3. puts them on the H100's roofline (:func:`roofline`).

XLA's ``cost_analysis()`` (loop bodies counted once) has no counterpart:
eager code counts every iteration, so the records have no
``xla_cost_analysis``. ``lower_s``/``compile_s`` become ``trace_s``.

Results are written incrementally to ``results/dryrun_torch.json`` so
interrupted runs resume; ``--only-missing`` skips completed cells.

Run:  python -m repro_torch.launch.dryrun --arch granite_3_2b --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as model_layers
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import tree_map
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.train_loop import (init_train_state, jit_train_step,
                                            make_train_step, place_state)

# H100 SXM roofline constants (NVIDIA's data sheet, the figures PERF.md's
# kernel bounds use): dense bf16 tensor-core peak and HBM3 bandwidth. The
# collective bandwidth is the per-card inter-node link of an HGX H100
# node, one 400 Gb/s NIC a card (50e9 B/s a direction): every axis of both
# production meshes (16 and 2x16 over 256 or 512 cards) crosses 8-card
# nodes. NVLink's 450 GB/s a direction inside a node is not used.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
ICI_BW = 50e9

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "results", "dryrun_torch.json")

_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def sds(shape, dtype):
    """A shape stand-in: a meta tensor (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=_DTYPES[dtype], device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, kind: str):
    """Meta stand-ins for every model input of a cell."""
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        batch = {"tokens": sds((b, s + 1), "int32")}
        seq = s
    elif kind == "prefill":
        batch = {"tokens": sds((b, s), "int32")}
        seq = s
    else:  # decode: one new token against a seq_len-deep cache
        batch = {"tokens": sds((b, 1), "int32")}
        seq = 1
    if cfg.family == "vlm":
        n_patch = min(64, max(1, seq // 2))
        batch["patch_embeds"] = sds((b, n_patch, cfg.d_model), "float32")
        batch["mrope_positions"] = sds((b, 3, seq), "int32")
    if cfg.family == "encdec":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), "float32")
    return batch


def model_flops(cfg: ArchConfig, shape: ShapeSpec, kind: str) -> float:
    """Useful MODEL_FLOPS: 6·N·D train (bwd+fwd), 2·N·D prefill, 2·N·B
    decode; N counts matmul-visible params (embedding gather excluded,
    unembed projection included)."""
    n = cfg.active_params() if cfg.family == "moe" else cfg.num_params()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model  # the lookup-only table
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# Per-arch microbatching (gradient accumulation): the standard knob for the
# largest train cells; the global batch is unchanged.
GRAD_ACCUM = {"qwen2_vl_7b": 2, "moonshot_v1_16b_a3b": 2}


def _place_batch(batch: dict, mesh) -> dict:
    return {k: sh.token_sharding(mesh, v.ndim, batch_size=v.shape[0])
            .place(v) for k, v in batch.items()}


def _laid_out(x, sharding):
    """``x`` (a DTensor) redistributed to ``sharding``: the reference's
    ``out_shardings``."""
    return x.redistribute(x.device_mesh, sharding.placements)


def build_cell(arch_id: str, shape_name: str, mesh, remat: str = "full",
               compress_grads: bool = False,
               grad_accum: int | None = None,
               serve_dtype: str = "bfloat16",
               serve_fsdp: bool = False,
               fsdp_gather_step: bool = False,
               cast_params_once: bool = False):
    """Returns (fn, example_args) for one cell: the state on the meta
    device laid out on ``mesh``, the inputs meta stand-ins.

    ``serve_dtype``: weights dtype for prefill/decode cells — bf16 by
    default (serving loads checkpoints cast down; keeping f32 masters
    doubles weight residency and every FSDP gather)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    kind = shape.kind
    if grad_accum is None:
        grad_accum = GRAD_ACCUM.get(arch_id, 1)
    bundle = build(cfg, remat=remat, device="meta")
    batch = input_specs(cfg, shape, kind)

    if kind == "train":
        opt_cfg = AdamWConfig()
        state = init_train_state(bundle, None, opt_cfg,
                                 compress_grads=compress_grads)
        gather_specs = None
        if fsdp_gather_step:
            gather_specs = tree_map(
                lambda s: tuple(None if a == "data" else a for a in s),
                sh.param_specs(state["params"], mesh))
        step = make_train_step(bundle, opt_cfg, compress_grads=compress_grads,
                               grad_accum=grad_accum,
                               cast_params_once=cast_params_once,
                               param_gather_specs=gather_specs)
        fn, _, _ = jit_train_step(step, state, mesh,
                                  {k: v.ndim for k, v in batch.items()})
        return fn, (state, batch)

    params = bundle.init(None)
    if serve_dtype != "float32":
        params = params.to(_DTYPES[serve_dtype])
    place_state(params, sh.param_shardings(params, mesh, fsdp=serve_fsdp))
    if kind == "prefill":
        max_len = shape.seq_len
        # logits (B, S, padded_vocab): batch over DP, vocab over model —
        # gathering the vocab dim on output would cost 30+ GiB/device on
        # the 256k-vocab archs
        logits_sh = sh.logits_sharding(mesh, 3, shape.global_batch,
                                       cfg.padded_vocab)

        def prefill_step(params, batch):
            with implicit_replication():
                logits, cache = bundle.prefill_fn(
                    params, _place_batch(batch, mesh), max_len)
                cache_sh = sh.cache_shardings(cache, mesh)
                return (_laid_out(logits, logits_sh),
                        tree_map(_laid_out, cache, cache_sh))
        return prefill_step, (params, batch)

    # decode / serve_step. Caches prefer kv-head sharding: the per-position
    # cache write must stay shard-local, which a sequence-sharded cache
    # breaks (the slice gathers the whole cache).
    cache = bundle.init_cache(shape.global_batch, shape.seq_len)
    place_state(cache, sh.cache_shardings(cache, mesh, prefer="heads"))
    logits_sh = sh.logits_sharding(mesh, 2, shape.global_batch,
                                   cfg.padded_vocab)
    pos = shape.seq_len - 1  # a full cache

    def serve_step(params, cache, tokens):
        with implicit_replication():
            tokens = sh.token_sharding(
                mesh, 2, batch_size=shape.global_batch).place(tokens)
            logits, cache = bundle.decode_fn(params, cache, tokens, pos)
            return _laid_out(logits, logits_sh), cache
    return serve_step, (params, cache, batch["tokens"])


def roofline(analysis: dict, cfg: ArchConfig, shape: ShapeSpec,
             kind: str, n_chips: int) -> dict:
    t_compute = analysis["flops"] / PEAK_FLOPS
    t_memory = analysis["bytes"] / HBM_BW
    t_coll = analysis["collective_bytes"] / ICI_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, kind)
    useful_t = mf / (n_chips * PEAK_FLOPS)
    bound = max(terms.values())
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_per_device": analysis["flops"],
        "useful_flops_ratio": (mf / n_chips) / max(analysis["flops"], 1.0),
        "roofline_fraction": useful_t / bound if bound > 0 else 0.0,
    }


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``"fake"`` process group of ``n_ranks`` ranks, this process rank
    0, destroyed on exit (``release_mesh`` leaves a group it did not make
    alone), with DTensor's sharding-propagation cache: its entries hold
    this world's meshes, which a later mesh of the same shape would get
    back from it."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        _clear_sharding_prop_cache()
        dist.destroy_process_group()


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all between two shard dims as on a card mesh:
    DTensor takes an all-gather and a chunk instead on a CPU mesh (gloo
    has no all-to-all), which the fake group does not need."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def _card_collectives():
    """DTensor's redistributions take the collectives they take on a
    card mesh (:func:`_shard_dim_alltoall`)."""
    from unittest import mock

    import torch.distributed.tensor.placement_types as placement_types

    with mock.patch.object(placement_types, "shard_dim_alltoall",
                           _shard_dim_alltoall):
        yield


def trace_step(fn, args, mesh, rec: dict, cfg: ArchConfig,
               shape: ShapeSpec) -> dict:
    """Run ``fn(*args)`` once under ``op_analysis.analyze`` with the
    activation-sharding hooks set for ``mesh``; fill ``rec`` with the
    trace time, the analysis, the memory and the roofline."""
    sizes = sh.axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in sh.batch_axes(mesh))
    model_layers.set_activation_sharding(sh.batch_axes(mesh), dp, "model",
                                         sizes["model"])
    try:
        t0 = time.time()
        with _card_collectives():
            summary = op_analysis.analyze(fn, *args)
        rec["trace_s"] = round(time.time() - t0, 2)
    finally:
        model_layers.clear_activation_sharding()
    rec["memory"] = summary.memory
    rec["analysis"] = summary.to_json()
    rec["roofline"] = roofline(rec["analysis"], cfg, shape, shape.kind,
                               math.prod(sizes.values()))
    return rec


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             remat: str = "full", compress_grads: bool = False) -> dict:
    n_chips = 512 if multi_pod else 256
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "kind": shape.kind, "ok": False}
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            t0 = time.time()
            fn, args = build_cell(arch_id, shape_name, mesh, remat=remat,
                                  compress_grads=compress_grads)
            rec["build_s"] = round(time.time() - t0, 2)
            trace_step(fn, args, mesh, rec, cfg, shape)
            rec["ok"] = True
    except Exception as e:  # record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in ARCH_IDS:
        for shape_name in cells(arch):
            out.append((arch, shape_name))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)

    out_path = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results: dict[str, dict] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    todo = all_cells()
    if args.arch:
        todo = [(a, s) for a, s in todo if a == args.arch]
    if args.shape:
        todo = [(a, s) for a, s in todo if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch, shape_name in todo:
        for multi in meshes:
            key = f"{arch}/{shape_name}/{'2x16x16' if multi else '16x16'}"
            if args.compress_grads:
                key += "/compressed"
            if args.only_missing and results.get(key, {}).get("ok"):
                continue
            print(f"[dryrun] {key} ...", flush=True)
            rec = run_cell(arch, shape_name, multi, remat=args.remat,
                           compress_grads=args.compress_grads)
            results[key] = rec
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
            if rec["ok"]:
                r = rec["roofline"]
                print(f"  ok trace={rec['trace_s']}s "
                      f"peak_mem={rec['memory']['peak_estimate_bytes']/1e9:.2f}GB "
                      f"dominant={r['dominant']} "
                      f"roofline_frac={r['roofline_fraction']:.3f}",
                      flush=True)
            else:
                print(f"  FAIL {rec['error']}", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells ok -> {out_path}")


if __name__ == "__main__":
    main()
