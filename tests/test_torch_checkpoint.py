"""The port's ``CheckpointManager``: the JAX package's checkpoint cases with
their assertions (round trip and GC, async and atomic, a property round
trip), a model's parameters through its ``state_dict``, and restores across
packages in both directions: a checkpoint either package writes restores in
the other, and the restored models compute the same logits — for the vlm
model and for a moe (stacked experts) and a hybrid (units and a tail) one."""

import dataclasses
import functools
import os

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint.checkpoint import (  # noqa: E402
    CheckpointManager as RefCheckpointManager)
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, state, extra={"data_step": step})
    assert mgr.all_steps() == [2, 3]  # keep=2 GC'd step 1
    step, restored, extra = mgr.restore(state, device="cpu")
    assert step == 3 and extra["data_step"] == 3
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones((128, 128))
    mgr.save(7, {"w": w}, async_save=True)
    w.fill_(2.0)  # the host copy was taken at save(): the file holds ones
    mgr.wait()
    assert mgr.latest_step() == 7
    # no stray temp dirs after publish
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    _, restored, _ = mgr.restore({"w": w}, device="cpu")
    assert torch.equal(restored["w"], torch.ones((128, 128)))


def test_failed_write_publishes_nothing(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(3)})

    def broken_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken_save)
    with pytest.raises(OSError):
        mgr.save(2, {"w": torch.ones(3)})
    assert mgr.all_steps() == [1]  # the latest checkpoint is untouched
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 100))
def test_checkpoint_property_roundtrip(tmp_path_factory, seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "nested": {"b": rng.integers(0, 9, (4,)).astype(np.int32)},
            "seq": [torch.tensor(rng.standard_normal(2))]}
    mgr = CheckpointManager(str(tmp_path_factory.mktemp("ck")))
    mgr.save(seed, tree)
    _, restored, _ = mgr.restore(tree, step=seed, device="cpu")
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(restored["nested"]["b"].numpy(),
                                  tree["nested"]["b"])
    assert isinstance(restored["seq"], list)
    assert torch.equal(restored["seq"][0], tree["seq"][0])


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's bundle (its forward jitted, so compiled once for
    the file's cases) and random parameters (immutable JAX arrays)."""
    rb = ref_build(ref_get_config(arch).reduced(), remat="none")
    rb = dataclasses.replace(rb, forward=jax.jit(rb.forward))
    return rb, rb.init(jax.random.key(3))


def _pair(arch="qwen2_vl_7b"):
    """The reference's bundle and random parameters, and the port's bundle
    and its own (different) random parameters, made anew (a restore loads
    them in place)."""
    port = build(get_config(arch).reduced(), remat="none", device="cpu")
    return (*_reference(arch), port,
            port.init(torch.Generator().manual_seed(3)))


def _logits_equal(rb, rp, port, params):
    batch = rb.make_batch(0, ShapeSpec("c", 8, 2, "train"), train=False)
    with torch.no_grad():
        ours = port.forward(params, batch).numpy()
    np.testing.assert_allclose(ours, np.asarray(rb.forward(rp, batch)),
                               rtol=1e-4, atol=1e-4)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rb, rp, port, params = _pair()
    RefCheckpointManager(str(tmp_path)).save(
        5, {"params": rp, "step": jnp.int32(5)}, extra={"data_step": 5})
    step, restored, extra = CheckpointManager(str(tmp_path)).restore(
        {"params": params, "step": 0}, device="cpu")
    assert step == 5 and extra == {"data_step": 5}
    assert restored["params"] is params  # loaded in place
    assert int(restored["step"]) == 5
    _logits_equal(rb, rp, port, params)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rb, rp, port, params = _pair()
    CheckpointManager(str(tmp_path)).save(
        9, {"params": params, "step": 9}, extra={"data_step": 9})
    names = {n[:-len(".npy")] for n in os.listdir(tmp_path / "step_00000009")
             if n.endswith(".npy")}
    assert "params__layers__attn__wq" in names and "step" in names
    step, restored, extra = RefCheckpointManager(str(tmp_path)).restore(
        {"params": rp, "step": jnp.int32(0)})
    assert step == 9 and extra == {"data_step": 9}
    _logits_equal(rb, restored["params"], port, params)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "recurrentgemma_2b"])
def test_family_checkpoints_restore_across_packages(tmp_path, arch):
    """A moe and a hybrid model: the port's checkpoint restores in the
    reference and the reference's in the port, leaf for leaf, and the
    restored models compute the same logits."""
    rb, rp, port, params = _pair(arch)
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": params}, extra={"arch": arch})
    _, theirs, extra = RefCheckpointManager(str(tmp_path / "port")).restore(
        {"params": rp})
    assert extra == {"arch": arch}
    _logits_equal(rb, theirs["params"], port, params)
    RefCheckpointManager(str(tmp_path / "ref")).save(2, {"params": rp})
    fresh = port.init(torch.Generator().manual_seed(4))
    _, ours, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": fresh}, device="cpu")
    assert ours["params"] is fresh
    flat = {"__".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    assert flat.keys() == {k.replace(".", "__")
                           for k in fresh.state_dict()}
    for key, value in fresh.state_dict().items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(flat[key.replace(".",
                                                                  "__")]))
    _logits_equal(rb, rp, port, fresh)
