"""The port's training loop against the JAX package's, on the CPU.

- ``make_train_step`` (plain, ``grad_accum=2``, ``compress_grads``,
  ``cast_params_once``) against the reference's jitted step from the same
  weights and batch: loss, grad norm, lr, the new parameters, moments and
  error feedback.
- Checkpoints across packages: a JAX ``Trainer``'s checkpoint restores in
  the port's ``Trainer`` and the port's in the JAX one's; the next step's
  loss agrees within 1e-4.
- The reference's test_runtime.py training and supervisor cases with
  their assertions (restart onto the same trajectory, stragglers, giving
  up after ``max_restarts``, training through int8 compression, the
  cast-once knob), and test_models_smoke.py's train-step cases over every
  architecture; the reference marks some slow for its compile time, the
  port's take a second or less here.
- The launcher: ``main`` with ``--device cpu`` (the step through
  ``jit_train_step`` on the one-device host mesh), a checkpoint directory,
  and the errors of ``--mesh production`` (too few ranks) and of a
  missing card.
"""

import dataclasses
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
from repro import configs as ref_configs  # noqa: E402
from repro.checkpoint.checkpoint import (  # noqa: E402
    CheckpointManager as RefCheckpointManager)
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_compression  # noqa: E402
from repro.runtime import train_loop as ref_train_loop  # noqa: E402

from _torch_jax import fast_jit  # noqa: E402
from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    CheckpointManager, _flatten)
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model_zoo import build, from_numpy_params  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, release_mesh  # noqa: E402
from repro_torch.optim.tree import leaves, nest, tree_map  # noqa: E402
from repro_torch.runtime.supervisor import (InjectedFailure,  # noqa: E402
                                            Supervisor)
from repro_torch.runtime.train_loop import (Trainer,  # noqa: E402
                                            init_train_state,
                                            jit_train_step,
                                            make_train_step)

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "granite_3_2b"
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _cfgs():
    return ref_configs.get_config(ARCH).reduced(), get_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _weights(seed=0):
    """The port's initial weights (numpy, the reference's tree)."""
    params = build(_cfgs()[1], device="cpu").init(
        torch.Generator().manual_seed(seed))
    return nest({n: p.detach().numpy() for n, p in params.named_parameters()})


def _port_state(compress_grads=False):
    params = from_numpy_params(_cfgs()[1], _weights(), "cpu")
    opt = adamw.init(params)
    if compress_grads:
        opt["ef"] = compression.init_error_feedback(params)
    return {"params": params, "opt": opt}


def _ref_state(compress_grads=False):
    params = jax.tree.map(jnp.asarray, _weights())
    opt = ref_adamw.init(params)
    if compress_grads:
        opt["ef"] = ref_compression.init_error_feedback(params)
    return {"params": params, "opt": opt}


@functools.lru_cache(maxsize=None)
def _ref_step(**knobs):
    rb = ref_build(_cfgs()[0], remat="none")
    return fast_jit(ref_train_loop.make_train_step(rb, OPT, **knobs))


KNOBS = [{}, {"grad_accum": 2}, {"compress_grads": True},
         {"cast_params_once": True}]
# Cast-once rounds every gradient to bf16 on its way back to the f32
# masters (the cast's backward), in both packages: moments within two bf16
# units (2^-7), their squares four.
BF16_GRADS = {"m": dict(rtol=2 ** -7, atol=1e-6),
              "v": dict(rtol=2 ** -6, atol=1e-12)}


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _off(ours, theirs, tol):
    """{leaf: boolean mask of the elements off ``tol``} over two trees."""
    want = _flat(theirs)
    got = dict(zip(want, (g.detach().numpy() for g in leaves(ours))))
    return {k: ~np.isclose(got[k], want[k], **tol) for k in want}, got, want


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k) or "plain")
def test_train_step_matches_reference(knobs):
    """One step from the same weights and batch: the metrics within TOL,
    the moments, error feedback and new parameters within TOL but for
    elements the arithmetic leaves ill conditioned, each named and
    bounded, on under 0.1 % of a leaf:

    - Adam's first step ``g / (|g| + eps)``: where ``sqrt(vhat)`` is under
      100 eps, gradients that agree within 1e-8 (g = -4.3e-9 against
      -8.9e-9 on one of granite's elements) move a parameter by amounts
      that differ by a third of lr; a parameter off TOL must be such an
      element (or a compression flip below), within two lr;
    - with ``compress_grads``, an element whose ``g / scale`` lies within
      the gradients' 1e-9 of a rounding tie rounds to the next integer:
      its dequantized gradient, so its moment and residual, differ by one
      quantization step; m, v and ef are off on those elements only;
    - with ``cast_params_once``, the gradients are bf16 (``BF16_GRADS``).
    """
    compress = knobs.get("compress_grads", False)
    ours, theirs = _port_state(compress), _ref_state(compress)
    step = make_train_step(build(_cfgs()[1], remat="none", device="cpu"),
                           OPT, **knobs)
    batch = SyntheticLM(_cfgs()[1].vocab_size, 16, 4, seed=0).batch_at(0)
    ours, m1 = step(ours, batch)
    theirs, m2 = _ref_step(**knobs)(theirs, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m1[key]), float(m2[key]),
                                   **TOL, err_msg=key)
    assert int(ours["opt"]["step"]) == int(theirs["opt"]["step"]) == 1

    moment_tol = (BF16_GRADS if knobs.get("cast_params_once")
                  else {"m": dict(rtol=1e-4, atol=1e-6),
                        "v": dict(rtol=1e-4, atol=1e-12)})
    off_m, got_m, want_m = _off(ours["opt"]["m"], theirs["opt"]["m"],
                                moment_tol["m"])
    flips = {k: np.zeros_like(v) for k, v in off_m.items()}
    if compress:
        flips = off_m
        for k, off in off_m.items():
            # g_hat = m / (1 - b1) at step 1; its largest entry is 127 steps
            q_step = np.abs(want_m[k]).max() / (1 - OPT.b1) / 127
            assert off.mean() < 1e-3, k
            np.testing.assert_allclose(
                got_m[k][off], want_m[k][off], rtol=0,
                atol=1.001 * (1 - OPT.b1) * q_step, err_msg=k)
        off_ef, _, _ = _off(ours["opt"]["ef"], theirs["opt"]["ef"],
                            dict(rtol=1e-4, atol=1e-6))
        assert all((off_ef[k] <= flips[k]).all() for k in flips)
    else:
        assert not any(off.any() for off in off_m.values()), \
            [k for k, off in off_m.items() if off.any()]
    off_v, _, want_v = _off(ours["opt"]["v"], theirs["opt"]["v"],
                            moment_tol["v"])
    assert all((off_v[k] <= flips[k]).all() for k in flips), \
        [k for k in flips if (off_v[k] > flips[k]).any()]

    off_p, got_p, want_p = _off(ours["params"], theirs["params"], TOL)
    for k, off in off_p.items():
        ill = np.sqrt(want_v[k] / (1 - OPT.b2)) <= 100 * OPT.eps
        assert (off <= (ill | flips[k])).all(), k
        assert off.mean() < 1e-3, k
        np.testing.assert_allclose(got_p[k][off], want_p[k][off], rtol=0,
                                   atol=2 * OPT.lr, err_msg=k)


def test_train_step_perf_knobs_numerics():
    """The perf train knobs (bf16 cast-once, explicit ZeRO-3 gather specs)
    must preserve training semantics; as the reference's test, the gather
    specs replicate every leaf and the step runs on the host mesh."""
    cfg = get_config(ARCH).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                      weight_decay=0.0)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=0).batch_at(0)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    _, m0 = make_train_step(bundle, opt)(state, batch)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    specs = tree_map(lambda _: (), state["params"])
    knob_step = make_train_step(bundle, opt, cast_params_once=True,
                                param_gather_specs=specs)
    try:
        knob_step, _, _ = jit_train_step(knob_step, state,
                                         make_host_mesh("cpu"), {"tokens": 2})
        _, m1 = knob_step(state, batch)
    finally:
        release_mesh()
    # bf16 cast perturbs the loss slightly; same order, finite, same scale
    assert np.isfinite(float(m1["loss"]))
    assert abs(float(m1["loss"]) - float(m0["loss"])) < 0.1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step(arch):
    """test_models_smoke's case: a reduced config's forward and one train
    step, finite, the parameters moved."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = bundle.make_batch(0, ShapeSpec("smoke", 32, 2, "train"))
    with torch.no_grad():
        logits = bundle.forward(params, {k: (v[:, :-1] if k == "tokens"
                                             else v)
                                         for k, v in batch.items()})
    assert logits.shape == (2, 32, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    before = [p.detach().clone() for p in leaves(state["params"])]
    state2, metrics = make_train_step(bundle, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    # params actually moved (the step writes them in place)
    moved = [float((a - b.detach()).abs().max())
             for a, b in zip(before, leaves(state2["params"]))]
    assert max(moved) > 0


@pytest.mark.parametrize("arch", ["bert_tiny", "mobilellm_125m"])
def test_paper_net_configs_train(arch):
    """The paper's own evaluation nets are selectable configs too."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    _, metrics = make_train_step(bundle, opt)(
        state, bundle.make_batch(0, ShapeSpec("smoke", 32, 2, "train")))
    assert np.isfinite(float(metrics["loss"]))


# ----------------------------------------------- checkpoints across packages --

def _port_trainer(directory):
    bundle = build(_cfgs()[1], remat="none", device="cpu")
    return Trainer(bundle, OPT, SyntheticLM(_cfgs()[1].vocab_size, 16, 4,
                                            seed=0),
                   _port_state(), make_train_step(bundle, OPT),
                   CheckpointManager(str(directory)), checkpoint_every=3)


def _ref_trainer(directory):
    rb = ref_build(_cfgs()[0], remat="none")
    return ref_train_loop.Trainer(
        rb, OPT, RefSyntheticLM(_cfgs()[0].vocab_size, 16, 4, seed=0),
        _ref_state(), _ref_step(), RefCheckpointManager(str(directory)),
        checkpoint_every=3)


def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path):
    theirs = _ref_trainer(tmp_path)
    want = [r.loss for r in theirs.run(4)]
    ours = _port_trainer(tmp_path)
    assert ours.restore_latest(device="cpu") == 3 and ours.data.step == 3
    assert int(ours.state["opt"]["step"]) == 3
    got = ours.run(1)[0]
    assert got.step == 3
    np.testing.assert_allclose(got.loss, want[3], rtol=1e-4)


def test_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    ours = _port_trainer(tmp_path)
    want = [r.loss for r in ours.run(4)]
    names = {n[:-len(".npy")] for n in os.listdir(tmp_path / "step_00000003")
             if n.endswith(".npy")}
    assert {"params__layers__attn__wq", "opt__m__layers__attn__wq",
            "opt__v__embedding", "opt__step"} <= names
    theirs = _ref_trainer(tmp_path)
    assert theirs.restore_latest() == 3 and theirs.data.step == 3
    got = theirs.run(1)[0]
    np.testing.assert_allclose(got.loss, want[3], rtol=1e-4)


# -------------------------------------------- the reference's runtime cases --

def _mk_trainer(tmp_path, n_ckpt=5):
    cfg = get_config(ARCH).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=100,
                      weight_decay=0.0)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    step = make_train_step(bundle, opt)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    return Trainer(bundle, opt, data, state, step, ckpt,
                   checkpoint_every=n_ckpt)


def test_compressed_training_converges():
    cfg = get_config(ARCH).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=60,
                      weight_decay=0.0)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt,
                             compress_grads=True)
    step = make_train_step(bundle, opt, compress_grads=True)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    losses = []
    for i in range(25):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5  # learns through int8 compression


def test_supervisor_restart_resumes_and_matches(tmp_path):
    """After an injected failure + restore, training must land on the SAME
    loss trajectory as an uninterrupted run (determinism of recovery)."""
    t_ref = _mk_trainer(tmp_path / "ref")
    ref_losses = [r.loss for r in t_ref.run(12)]

    t = _mk_trainer(tmp_path / "run")
    crashed = {}

    def bomb(step):
        if step == 8 and not crashed:
            crashed["x"] = True
            raise InjectedFailure()
    sup = Supervisor(t, failure_hook=bomb,
                     heartbeat_path=str(tmp_path / "hb.json"))
    rep = sup.run(12)
    assert rep.restarts == 1
    assert rep.completed_steps == 12
    # steps 10/11 (post-restore, re-run from ckpt@5) match the reference
    final = sorted(r.loss for r in t.records if r.step in (10, 11))
    ref = sorted(l for i, l in enumerate(ref_losses) if i in (10, 11))
    np.testing.assert_allclose(final, ref, rtol=1e-5)
    assert os.path.exists(tmp_path / "hb.json")


def test_supervisor_straggler_detection(tmp_path):
    t = _mk_trainer(tmp_path, n_ckpt=50)
    sup = Supervisor(t, straggler_factor=2.5,
                     delay_hook=lambda s: 0.3 if s == 9 else 0.0)
    rep = sup.run(12)
    assert 9 in rep.stragglers
    assert len(rep.stragglers) <= 3


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    t = _mk_trainer(tmp_path)

    def always_bomb(step):
        raise InjectedFailure()
    sup = Supervisor(t, max_restarts=2, failure_hook=always_bomb)
    with pytest.raises(InjectedFailure):
        sup.run(5)
    assert sup.restarts == 2


# -------------------------------------------------------------- launcher ----

def test_launcher_runs_on_the_cpu(capsys, tmp_path):
    report = launch_train.main(["--device", "cpu", "--steps", "3",
                                "--checkpoint-dir", str(tmp_path),
                                "--checkpoint-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert out[-1].startswith("final loss ") and \
        "(restarts=0, stragglers=" in out[-1]
    assert report.completed_steps == 3 and len(report.losses) == 3
    assert all(np.isfinite(report.losses))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    # the mesh's process group and the layers' hooks are gone after
    assert not torch.distributed.is_initialized()
    assert launch_train.model_layers._BATCH_AXES is None


def test_launcher_defaults_are_the_reference_s():
    args = launch_train.parse_args([])
    assert (args.arch, args.steps, args.seq_len, args.batch, args.lr,
            args.reduced, args.mesh, args.remat, args.grad_accum,
            args.compress_grads, args.checkpoint_every, args.seed,
            args.device) == ("granite_3_2b", 100, 128, 8, 3e-3, True,
                             "host", "none", 1, False, 50, 0, "cuda")
    assert not launch_train.parse_args(["--no-reduced"]).reduced


def test_launcher_refuses_what_it_cannot_run(monkeypatch):
    # the production mesh needs 256 ranks; this process is a world of one
    with pytest.raises(RuntimeError,
                       match=r"16x16 mesh .* needs 256 ranks; this world "
                             r"has 1"):
        launch_train.main(["--device", "cpu", "--mesh", "production"])
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])


def test_trainer_state_mirrors_the_reference_tree():
    """The port's train state has the reference's leaves, name for name
    and shape for shape, error feedback included."""
    cfg = get_config(ARCH).reduced()
    ours = init_train_state(build(cfg, device="cpu"),
                            torch.Generator().manual_seed(0), OPT,
                            compress_grads=True)
    theirs = jax.eval_shape(functools.partial(
        ref_train_loop.init_train_state, ref_build(_cfgs()[0]),
        opt_cfg=OPT, compress_grads=True), jax.random.key(0))
    flat = {"__".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                theirs)[0]}
    got = _flatten(ours)
    assert got.keys() == flat.keys()
    for key, value in got.items():
        assert value.shape == flat[key].shape, key
        assert str(value.dtype) == str(flat[key].dtype), key
    assert dataclasses.asdict(OPT) == dataclasses.asdict(
        ref_adamw.AdamWConfig(**dataclasses.asdict(OPT)))
