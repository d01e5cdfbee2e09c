"""The sharded training path on four CPU processes: a gloo group on a 2x2
("data", "model") mesh (one spawn, initialized through a FileStore under
``tmp_path``: no TCP port), against the JAX package's ``jit_train_step``
on its one-device host mesh, from the same weights and ``make_batch``
batches:

- (a) two steps of ``jit_train_step`` at ``granite_3_2b.reduced()``,
  without and with ``param_gather_specs`` (ZeRO-3: the gather's gradients
  come back in the storage placements);
- (b) one step at ``qwen2_moe_a2_7b.reduced()`` (experts over "model"),
  and one each at ``mamba2_780m``, ``recurrentgemma_2b`` and
  ``whisper_tiny`` ``reduced()`` (the SSM, hybrid and encoder-decoder
  families; Whisper's batch carries frames beside the tokens);
- (c) elastic restore: the state saved under 2x2 restores onto 2x2 (its
  placements kept) and onto one device, equal to what was saved;
- (d) ``compressed_all_reduce`` over the four ranks, bit-equal to the
  reference's ``compressed_psum`` vmapped over the four stacked shards.

The metrics within rtol 1e-4 / atol 1e-5 (``tests/test_torch_train_grads.py``'s
tolerance); the moments and parameters as ``tests/test_torch_train_loop.py``
holds one step, the parameters but for elements Adam's first steps leave
ill conditioned, each bounded. The ranks are joined with a timeout: a hang
fails the test. Also, on the one-device host mesh, the reference's
test_runtime.py elastic-restore case and a launcher trainer restoring onto
its own layout.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as P  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_compression  # noqa: E402
from repro.runtime import sharding as ref_sh  # noqa: E402
from repro.runtime import train_loop as ref_train_loop  # noqa: E402

import _torch_sharded_worker as worker  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, release_mesh  # noqa: E402
from repro_torch.models.model_zoo import build, from_numpy_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.tree import nest  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)
ARCHS = tuple(dict.fromkeys(arch for arch, _ in worker.CASES))
SEEDS = ((0, "float32"), (1, "bfloat16"))
# the XLA backend at optimization level 0 (tests/_torch_jax.py's fast_jit)
FAST = {"xla_backend_optimization_level": 0}
JOIN_S = 300


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's initial weights at ``reduced()`` (numpy, the reference's
    tree)."""
    params = build(get_config(arch).reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    return nest({n: p.detach().numpy() for n, p in params.named_parameters()})


def _flat(tree, prefix=()):
    """{"a/b": numpy} of a nested dict or a JAX tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _reference(arch, gather):
    """The reference's ``jit_train_step`` on its host mesh's shape and axes,
    the axes of GSPMD's Auto type its ZeRO-3 ``with_sharding_constraint``
    was written for (``jax.make_mesh`` now defaults to Explicit axes, under
    which the constraint is an assertion): the metrics of
    ``worker.STEPS[arch]`` steps and the final params, m and v."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    rb = ref_build(ref_configs.get_config(arch).reduced(), remat="none")
    params = jax.tree.map(jnp.asarray, _weights(arch))
    specs = None
    if gather:
        specs = jax.tree.map(
            lambda s: P(*[None if a == "data" else a for a in s]),
            ref_sh.param_specs(params, mesh),
            is_leaf=lambda x: isinstance(x, P))
    step = ref_train_loop.make_train_step(rb, OPT, param_gather_specs=specs)
    state = {"params": params, "opt": ref_adamw.init(params)}
    batches = [rb.make_batch(i, ShapeSpec("t", worker.SEQ, worker.BATCH,
                                          "train"))
               for i in range(worker.STEPS[arch])]
    jitted, _, _ = ref_train_loop.jit_train_step(
        step, state, mesh, {k: v.ndim for k, v in batches[0].items()})
    metrics = []
    with jax.set_mesh(mesh):  # the gather's specs name the mesh's axes
        compiled = jitted.lower(state, batches[0]).compile(FAST)
        for batch in batches:
            state, m = compiled(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _flat(state["params"]),
            "m": _flat(state["opt"]["m"]), "v": _flat(state["opt"]["v"]),
            "step": int(state["opt"]["step"])}


def _check_leaf(got, want, name, steps, label):
    """One leaf's moments in gradient units, ``m / (1 - b1^t)`` and
    ``sqrt(v / (1 - b2^t))``, within the gradients' TOL: the ranks sum each
    gradient in another order than one device does. Its parameter within
    TOL but for elements where Adam's ``mhat / (sqrt(vhat) + eps)`` is ill
    conditioned, off on under 0.1 % of the leaf and by at most 2 lr a
    step: at the first step where ``sqrt(vhat)`` is under 100 eps (there
    gradients that agree within 1e-8 give updates a third of lr apart);
    after it where ``sqrt(vhat)`` is under 100 times TOL's atol, since the
    elements the first step left apart move the next step's gradients by
    up to that much."""
    units = {"m": lambda m: m / (1 - OPT.b1 ** steps),
             "v": lambda v: np.sqrt(v / (1 - OPT.b2 ** steps))}
    for key, to_grad in units.items():
        np.testing.assert_allclose(to_grad(_flat(got[key])[name]),
                                   to_grad(want[key][name]), **TOL,
                                   err_msg=f"{label} {key} {name}")
    value, ref = _flat(got["params"])[name], want["params"][name]
    off = ~np.isclose(value, ref, **TOL)
    ill = units["v"](want["v"][name]) <= 100 * (OPT.eps if steps == 1
                                                else TOL["atol"])
    assert (off <= ill).all() and off.mean() < 1e-3, \
        (label, name, int(off.sum()), int((off & ~ill).sum()))
    np.testing.assert_allclose(value[off], ref[off], rtol=0,
                               atol=2 * OPT.lr * steps,
                               err_msg=f"{label} {name}")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Spawn the four ranks; while they run, compute the reference's steps
    here (on the same ``make_batch`` batches); join them with a timeout.
    Returns (ranks' result, references, checkpoint directory)."""
    out = str(tmp_path_factory.mktemp("sharded"))
    weights = os.path.join(out, "weights.pt")
    torch.save({arch: _weights(arch) for arch in ARCHS}, weights)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(rank, 4, os.path.join(out, "store"), out,
                               weights, OPT, SEEDS), daemon=True)
             for rank in range(4)]
    for p in procs:
        p.start()
    try:
        refs = {case: _reference(*case) for case in worker.CASES}
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not alive, f"ranks {alive} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * 4, \
        [p.exitcode for p in procs]
    result = torch.load(os.path.join(out, "result.pt"), weights_only=False)
    return result, refs, os.path.join(out, "ckpt")


def _leaf_names(arch):
    return sorted(_flat(_weights(arch)))


CASE_IDS = {("granite_3_2b", False): "dense",
            ("granite_3_2b", True): "dense-zero3",
            ("qwen2_moe_a2_7b", False): "moe",
            ("mamba2_780m", False): "ssm",
            ("recurrentgemma_2b", False): "hybrid",
            ("whisper_tiny", False): "encdec"}


@pytest.mark.parametrize(
    "case,step", [(case, i) for case in worker.CASES
                  for i in range(worker.STEPS[case[0]])],
    ids=lambda v: CASE_IDS.get(v, str(v)))
def test_step_metrics_match_reference(sharded, case, step):
    """Each step's loss, grad norm and lr."""
    got, want = sharded[0][case], sharded[1][case]
    assert len(got["metrics"]) == len(want["metrics"]) == \
        worker.STEPS[case[0]]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][step][key],
                                   want["metrics"][step][key], **TOL,
                                   err_msg=f"{case} step {step} {key}")


@pytest.mark.parametrize(
    "case,leaf", [(case, name) for case in worker.CASES
                  for name in _leaf_names(case[0])],
    ids=lambda v: CASE_IDS.get(v, str(v)))
def test_state_matches_reference(sharded, case, leaf):
    """Each leaf's moments and parameters after the steps."""
    got, want = sharded[0][case], sharded[1][case]
    steps = worker.STEPS[case[0]]
    assert got["step"] == want["step"] == steps
    assert _flat(got["params"]).keys() == want["params"].keys()
    _check_leaf(got, want, leaf, steps, f"{case}")


def test_zero3_gradients_come_back_in_the_storage_placements(sharded):
    """With ``param_gather_specs``, each gradient of the gathered
    parameters is laid out as its (FSDP x TP) parameter: the gather's
    backward reduce-scattered it."""
    assert sharded[0]["granite_3_2b", True]["grads_in_storage"] is True


def test_elastic_restore_round_trips(sharded):
    """Saved under 2x2: onto 2x2 the placements are the state's and the
    values equal; onto one device (this process, no group) too."""
    result, _, ckpt_dir = sharded
    saved = result["granite_3_2b", False]
    restored = result["restored"]
    assert restored["placements_kept"] is True
    assert restored["step"] == saved["step"]
    for key in ("params", "m"):
        for name, value in _flat(saved[key]).items():
            np.testing.assert_array_equal(_flat(restored[key])[name], value)
    cfg = get_config("granite_3_2b").reduced()
    fresh = from_numpy_params(cfg, _weights("granite_3_2b"), "cpu")
    step, state, _ = CheckpointManager(ckpt_dir).restore(
        {"params": fresh, "opt": adamw.init(fresh)}, device="cpu")
    assert step == 1 and int(state["opt"]["step"]) == saved["step"]
    for name, p in state["params"].named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), _flat(saved["params"])[name.replace(".", "/")])


def test_kv_heads_the_model_axis_does_not_divide(sharded):
    """``granite_3_2b.reduced()``'s 2 KV heads on the four ranks as one
    (1, 4) row: the projections' outputs are sharded four ways over
    "model", which does not divide the heads (``layers.split_heads``
    replicates that mesh dim before the view, where DTensor refused to
    unflatten the uneven shard). Loss and grad norm within 1e-6 of the
    unsharded step's, the parameters within 3e-5 (the bounds
    ``tools/sharded_families_check.py`` measured for the other families)
    but where Adam's first update is ill conditioned (``_check_leaf``'s
    rule): there within 2 lr."""
    got = sharded[0]["uneven_heads"]
    assert got["kv_heads"] % 4
    for key in ("loss", "grad_norm"):
        assert abs(got[f"sharded_{key}"] - got[key]) <= 1e-6, (key, got)
    assert got["max_param_diff"] <= 3e-5, got
    assert got["max_ill_param_diff"] <= 2 * OPT.lr, got


def test_query_heads_the_model_axis_does_not_divide(sharded):
    """``granite_3_2b.reduced()`` with 6 query heads (2 KV heads) on the
    four ranks as one (1, 4) row: "model" divides neither head count, so
    each rank attends over its 4 of the 16 query rows against the whole
    K/V (``layers._heads_local``). Held to the unsharded step as
    :func:`test_kv_heads_the_model_axis_does_not_divide` holds its case."""
    got = sharded[0]["row_split"]
    assert got["q_heads"] % 4 and got["kv_heads"] % 4
    for key in ("loss", "grad_norm"):
        assert abs(got[f"sharded_{key}"] - got[key]) <= 1e-6, (key, got)
    assert got["max_param_diff"] <= 3e-5, got
    assert got["max_ill_param_diff"] <= 2 * OPT.lr, got


def test_meta_state_draws_nothing():
    """``build(..., device="meta")`` and ``init_train_state`` give
    Moonshot-v1-16B-A3B's state (115.6 GB of f32 masters, twice that in
    moments) as meta tensors, drawing nothing in host memory, leaf for
    leaf of the reference's ``jax.eval_shape`` of its
    ``init_train_state``."""
    arch = "moonshot_v1_16b_a3b"
    rss = lambda: int(open("/proc/self/statm").read().split()[1]) \
        * os.sysconf("SC_PAGE_SIZE")
    before = rss()
    state = train_loop.init_train_state(
        build(get_config(arch), remat="none", device="meta"), None,
        AdamWConfig())
    grown = rss() - before
    flat = {"params/" + n.replace(".", "/"): p
            for n, p in state["params"].named_parameters()}
    for key in ("m", "v"):
        flat.update({f"opt/{key}/{n}": t
                     for n, t in _flat_tensors(state["opt"][key]).items()})
    flat["opt/step"] = state["opt"]["step"]
    assert all(t.is_meta for t in flat.values())
    assert grown < 256 * 2**20, grown
    rb = ref_build(ref_configs.get_config(arch), remat="none")
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: ref_train_loop.init_train_state(rb, k,
                                                  ref_adamw.AdamWConfig()),
        jax.random.key(0)))
    want = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in leaves}
    assert sorted(flat) == sorted(want)
    for name, t in flat.items():
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            (tuple(want[name].shape), str(want[name].dtype)), name


def _flat_tensors(tree, prefix=()):
    """{"a/b": tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("seed,dtype", SEEDS)
def test_compressed_all_reduce_over_four_ranks(sharded, seed, dtype):
    result = sharded[0]
    xs = np.stack([(np.random.default_rng(seed + r).standard_normal((16, 24))
                    * 3).astype(np.float32) for r in range(4)])
    want = jax.vmap(functools.partial(ref_compression.compressed_psum,
                                      axis_name="ranks"),
                    axis_name="ranks")(jnp.asarray(xs, dtype))
    for rank, per_rank in enumerate(result["all_reduce"]):
        got_dtype, got = per_rank[seed, dtype]
        assert got_dtype == f"torch.{dtype}"
        np.testing.assert_array_equal(got, np.asarray(want[rank],
                                                      np.float32))


def test_trainer_restores_onto_its_mesh(tmp_path):
    """A trainer of the launcher's ``--mesh host`` restores its checkpoint
    onto its own layout (``restore_latest()`` takes the trainer's
    shardings), or onto a device when asked (``device=``)."""
    args = launch_train.parse_args(["--device", "cpu", "--checkpoint-dir",
                                    str(tmp_path)])
    with launch_train.train_mesh(args) as mesh:
        trainer = launch_train.make_trainer(args, mesh)
        wq = trainer.state["params"].layers.attn.wq
        saved = wq.full_tensor().detach().clone()
        trainer.save_checkpoint()
        with torch.no_grad():
            wq.add_(1.0)
        assert trainer.restore_latest() == 0
        wq = trainer.state["params"].layers.attn.wq
        assert wq.device_mesh is mesh
        assert tuple(wq.placements) == \
            trainer.shardings["params"]["layers"]["attn"]["wq"].placements
        np.testing.assert_array_equal(wq.full_tensor().detach().numpy(),
                                      saved.numpy())
        cfg = get_config(args.arch).reduced()
        fresh = from_numpy_params(cfg, _weights(args.arch), "cpu")
        trainer.state = {"params": fresh, "opt": adamw.init(fresh)}
        trainer.restore_latest(device="cpu")
        np.testing.assert_array_equal(
            trainer.state["params"].layers.attn.wq.detach().numpy(),
            saved.numpy())
    assert not dist.is_initialized()


def test_checkpoint_elastic_restore(tmp_path):
    """The reference's test_runtime.py case: a checkpoint restores onto
    the one-device host mesh with explicit shardings (the elastic path)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, state)
    mesh = make_host_mesh("cpu")
    try:
        shardings = {"w": sh.NamedSharding(mesh, ("data", "model"))}
        _, restored, _ = mgr.restore(state, shardings=shardings)
        assert restored["w"].device_mesh is mesh
        assert tuple(restored["w"].placements) == shardings["w"].placements
        np.testing.assert_array_equal(restored["w"].full_tensor().numpy(),
                                      np.arange(16.0).reshape(4, 4))
    finally:
        release_mesh()
    assert not dist.is_initialized()
