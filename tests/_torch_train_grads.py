"""Shared gradient parity check for the test_torch_train_grads* files: the
port's loss and every gradient leaf (autograd, under each ``remat``
policy) against ``jax.value_and_grad`` of the reference's loss, on the
reference's weights carried across, at ``reduced()`` widths in f32.

The reference's jitted ``value_and_grad`` dominates a file's time, so it
runs once per (arch, config overrides) and is shared by the file's cases.
"""

import dataclasses
import functools

import jax
import numpy as np
import torch
from repro import configs as ref_configs
from repro.models.model_zoo import build as ref_build

from _torch_jax import fast_jit
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.model_zoo import build, from_numpy_params
from repro_torch.optim.tree import nest

TOL = dict(rtol=1e-4, atol=1e-5)
SEQ, BATCH = 16, 2


def configs(arch, **overrides):
    """The reduced f32 config of ``arch`` in both packages."""
    return (dataclasses.replace(ref_configs.get_config(arch).reduced(),
                                dtype="float32", **overrides),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **overrides))


@functools.lru_cache(maxsize=None)
def reference(arch, seq=SEQ, **overrides):
    """(weights as numpy, batch, loss, {"a__b": gradient}) of the
    reference: ``jax.value_and_grad`` of its loss, remat none. The weights
    are the port's ``init`` (its tree is the reference's, name for name),
    which costs less than the reference's eager one."""
    ref_cfg, cfg = configs(arch, **overrides)
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    weights = nest({name: p.detach().numpy()
                    for name, p in params.named_parameters()})
    rb = ref_build(ref_cfg, remat="none")
    batch = rb.make_batch(0, ShapeSpec("g", seq, BATCH, "train"))
    loss, grads = fast_jit(jax.value_and_grad(rb.loss_fn))(weights, batch)
    flat = {"__".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return weights, batch, float(loss), flat


def port_loss_and_grads(arch, remat, seq=SEQ, **overrides):
    weights, batch, _, _ = reference(arch, seq, **overrides)
    _, cfg = configs(arch, **overrides)
    params = from_numpy_params(cfg, weights, "cpu")
    bundle = build(cfg, remat=remat, device="cpu")
    loss = bundle.loss_fn(params, batch)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(names, grads))


def check_gradients(arch, remat, seq=SEQ, **overrides):
    """The port's loss and each gradient leaf equal the reference's."""
    _, _, want_loss, want = reference(arch, seq, **overrides)
    loss, grads = port_loss_and_grads(arch, remat, seq, **overrides)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert {n.replace(".", "__") for n in grads} == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name.replace(".", "__")],
                                   **TOL, err_msg=f"{arch} {remat} {name}")
