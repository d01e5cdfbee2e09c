"""The port's training substrate against the JAX package's, on the CPU:
``SyntheticLM``, AdamW and gradient compression.

- ``SyntheticLM`` batches bit-equal to the reference's over seeds, steps
  and hosts.
- ``adamw.update`` (new parameters, moments, step, grad norm, lr) and
  ``schedule`` on random trees within 1e-6.
- ``quantize_int8`` exact (q and scale), ``compress_with_feedback``
  within 1e-6, and ``compressed_all_reduce`` on a one-process gloo group
  equal to the reference's ``compressed_psum`` under a one-device
  ``shard_map``.
- The reference's test_runtime.py data, optimizer and compression cases,
  with their assertions.
"""

import dataclasses
import functools

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
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_compression  # noqa: E402

from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _random_tree(seed, scale=1.0):
    """A nested tree of f32 numpy leaves of assorted shapes."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"embedding": f(11, 6), "final_norm": f(6),
            "layers": {"attn": {"wq": f(2, 6, 8), "wo": f(2, 8, 6)},
                       "mlp": {"w_up": f(2, 6, 10)}}}


def _torch_tree(tree):
    return tree_map(lambda x: torch.tensor(x), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(ours, theirs, **tol):
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    got = leaves(ours)
    assert len(got) == len(flat)
    for g, (path, want) in zip(got, flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------- data ----

@pytest.mark.parametrize("seed,step,n_hosts,host_id,noise",
                         [(0, 0, 1, 0, 0.1), (3, 5, 2, 1, 0.1),
                          (7, 1234, 4, 2, 0.1), (1, 9, 1, 0, 0.5)])
def test_batches_bit_equal_to_the_reference(seed, step, n_hosts, host_id,
                                            noise):
    kw = dict(vocab_size=997, seq_len=24, global_batch=8, n_hosts=n_hosts,
              host_id=host_id, seed=seed, noise=noise)
    ours, theirs = SyntheticLM(**kw), RefSyntheticLM(**kw)
    got, want = ours.batch_at(step), theirs.batch_at(step)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    ours.step = theirs.step = step
    np.testing.assert_array_equal(next(ours)["tokens"],
                                  next(theirs)["tokens"])
    assert ours.state_dict() == theirs.state_dict()


def test_data_deterministic_and_host_sharded():
    a = SyntheticLM(100, 16, 8, n_hosts=2, host_id=0, seed=3)
    b = SyntheticLM(100, 16, 8, n_hosts=2, host_id=1, seed=3)
    x0 = a.batch_at(5)["tokens"]
    x0_again = SyntheticLM(100, 16, 8, n_hosts=2, host_id=0,
                           seed=3).batch_at(5)["tokens"]
    np.testing.assert_array_equal(x0, x0_again)
    assert x0.shape == (4, 17)
    assert not np.array_equal(x0, b.batch_at(5)["tokens"])  # disjoint shards


def test_data_checkpoint_resume():
    d = SyntheticLM(50, 8, 4, seed=1)
    for _ in range(3):
        next(d)
    state = d.state_dict()
    ref = next(d)["tokens"]
    d2 = SyntheticLM(50, 8, 4, seed=1)
    d2.load_state_dict(state)
    np.testing.assert_array_equal(next(d2)["tokens"], ref)


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 10_000), vocab=st.integers(2, 65536))
def test_data_tokens_in_range(step, vocab):
    d = SyntheticLM(vocab, 8, 2, seed=0)
    t = d.batch_at(step)["tokens"]
    assert t.min() >= 0 and t.max() < vocab


# ------------------------------------------------------------------ adamw ----

CFGS = [AdamWConfig(),
        AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                    weight_decay=0.0, grad_clip=0.5),
        AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=5,
                    min_lr_ratio=0.0, grad_clip=100.0)]


@pytest.mark.parametrize("cfg", CFGS)
def test_schedule_matches_reference(cfg):
    for step in (0, 1, 2, 3, 4, 7, 19, 20, 50, 99, 100, 5000, 10_000,
                 20_000):
        want = float(ref_adamw.schedule(cfg, jnp.int32(step)))
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)
        np.testing.assert_allclose(float(adamw.schedule(cfg, step)),
                                   float(ref_adamw.schedule(cfg, step)),
                                   **TOL)


@pytest.mark.parametrize("cfg_index", range(len(CFGS)))
def test_update_matches_reference(cfg_index):
    """Three steps from nonzero moments: parameters, moments, step, the
    grad norm (clipping on and off) and the lr within 1e-6."""
    cfg = CFGS[cfg_index]
    params = _random_tree(1)
    state = {"m": _random_tree(2, 0.1),
             "v": tree_map(np.abs, _random_tree(3, 0.01)), "step": 2}
    ours_p = _torch_tree(params)
    ours_s = {"m": _torch_tree(state["m"]), "v": _torch_tree(state["v"]),
              "step": torch.tensor(state["step"], dtype=torch.int32)}
    theirs_p = _jax_tree(params)
    theirs_s = {"m": _jax_tree(state["m"]), "v": _jax_tree(state["v"]),
                "step": jnp.int32(state["step"])}
    ref_update = jax.jit(functools.partial(ref_adamw.update, cfg=cfg))
    for i in range(3):
        grads = _random_tree(10 + i, scale=0.2 + i)
        ours_p, ours_s, m1 = adamw.update(_torch_tree(grads), ours_s,
                                          ours_p, cfg)
        theirs_p, theirs_s, m2 = ref_update(_jax_tree(grads), theirs_s,
                                            theirs_p)
        _assert_trees_close(ours_p, theirs_p, **TOL)
        _assert_trees_close(ours_s["m"], theirs_s["m"], **TOL)
        _assert_trees_close(ours_s["v"], theirs_s["v"], **TOL)
        assert int(ours_s["step"]) == int(theirs_s["step"]) == 3 + i
        assert ours_s["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m1[key]), float(m2[key]),
                                       **TOL)


def test_update_writes_in_place_and_mirrors_the_tree():
    params = _torch_tree(_random_tree(4))
    state = adamw.init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert leaves(state["m"])[0].shape == leaves(params)[0].shape
    before = [p.clone() for p in leaves(params)]
    new_params, new_state, _ = adamw.update(_torch_tree(_random_tree(5)),
                                            state, params, AdamWConfig())
    assert new_params is params and new_state["m"] is state["m"]
    assert all(not torch.equal(a, b)
               for a, b in zip(before, leaves(params)))
    assert int(new_state["step"]) == 1 and int(state["step"]) == 0


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(grads, state, params, cfg)
    assert float(torch.abs(params["w"]).max()) < 0.1


def test_adamw_grad_clip():
    cfg = AdamWConfig(grad_clip=1.0)
    g = {"w": torch.full((4,), 100.0)}
    state = adamw.init(g)
    _, _, metrics = adamw.update(g, state, {"w": torch.zeros((4,))}, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


# ------------------------------------------------------------ compression ----

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 40.0),
                                        (3, 0.0)])
def test_quantize_matches_reference_exactly(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties: half to even in both
    q, s = compression.quantize_int8(torch.tensor(x))
    rq, rs = ref_compression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(ref_compression.dequantize_int8(rq, rs)))


def test_compress_with_feedback_matches_reference():
    ours_ef = compression.init_error_feedback(_torch_tree(_random_tree(0)))
    theirs_ef = ref_compression.init_error_feedback(
        _jax_tree(_random_tree(0)))
    # eagerly: under jit XLA fuses g32 - q * scale into an FMA, whose
    # residual differs by an ulp of g32 (1e-6 of a residual at scale 10)
    ref_step = ref_compression.compress_with_feedback
    for i in range(4):
        grads = _random_tree(20 + i, scale=10.0 ** (i - 2))
        g_hat, ours_ef = compression.compress_with_feedback(
            _torch_tree(grads), ours_ef)
        r_hat, theirs_ef = ref_step(_jax_tree(grads), theirs_ef)
        _assert_trees_close(g_hat, r_hat, **TOL)
        _assert_trees_close(ours_ef, theirs_ef, **TOL)


@pytest.fixture
def gloo_group():
    """A one-process gloo group (an in-memory store: no port, no peer)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed,dtype", [(0, "float32"), (1, "bfloat16")])
def test_compressed_all_reduce_matches_compressed_psum(gloo_group, seed,
                                                       dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, 24)) * 3).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    psum = jax.jit(jax.shard_map(
        functools.partial(ref_compression.compressed_psum, axis_name="pod"),
        mesh=mesh, in_specs=P(), out_specs=P()))
    want = psum(jnp.asarray(x, dtype))
    got = compression.compressed_all_reduce(
        torch.tensor(x).to(getattr(torch, dtype)), group=gloo_group)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 1000))
def test_quantize_error_bound(seed):
    """int8 quantization error is bounded by scale/2 per element."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((32, 16)).astype(np.float32) * 10)
    q, scale = compression.quantize_int8(x)
    err = np.abs(compression.dequantize_int8(q, scale).numpy() - x.numpy())
    assert err.max() <= float(scale) * 0.5 + 1e-6


def test_error_feedback_preserves_signal():
    """Sum of EF-compressed gradients tracks the sum of true gradients —
    the residual never escapes (Karimireddy et al. property)."""
    rng = np.random.default_rng(0)
    grads = [{"w": torch.tensor(rng.standard_normal((8, 8)),
                                dtype=torch.float32)} for _ in range(20)]
    ef = compression.init_error_feedback(grads[0])
    total_hat = torch.zeros((8, 8))
    total_true = torch.zeros((8, 8))
    for g in grads:
        g_hat, ef = compression.compress_with_feedback(g, ef)
        total_hat += g_hat["w"]
        total_true += g["w"]
    resid = np.abs((total_hat + ef["w"] - total_true).numpy()).max()
    assert resid < 1e-4


def test_config_is_the_reference_s():
    assert ([f.name for f in dataclasses.fields(AdamWConfig)]
            == [f.name for f in dataclasses.fields(ref_adamw.AdamWConfig)])
    assert AdamWConfig() == AdamWConfig(**dataclasses.asdict(
        ref_adamw.AdamWConfig()))
