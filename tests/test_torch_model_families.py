"""The port's MoE, SSM, hybrid and encoder-decoder families against the JAX
package's, on the CPU at ``reduced()``.

- ``forward``, ``prefill`` (logits and every cache entry) and
  ``decode_step`` of qwen2_moe_a2_7b, moonshot_v1_16b_a3b, mamba2_780m,
  recurrentgemma_2b and whisper_tiny, on the reference's weights carried
  across with ``from_numpy_params``: f32 within rtol 1e-4 / atol 1e-4,
  bf16 5e-2.
- MoE routing equal to the reference's exactly: each token's experts in
  order, which assignments capacity keeps and the slot of each, on a case
  that overflows capacity and on tied router logits (the lower index
  first, as ``lax.top_k``).
- The parameter trees: the port's own ``init`` has the reference's names
  and shapes, and every one of the twelve configs builds and runs.
- The reference's test_models_smoke.py cases for these families with their
  assertions: prefill->decode against the teacher-forced forward,
  ``test_mamba2_chunking_invariance`` and recurrentgemma's ring KV cache.

The reference is built, initialised and jitted once per (arch, dtype) and
shared by the tests that read it.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_jax import fast_jit  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402

from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import (build,  # noqa: E402
                                          from_numpy_params)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
FAMILIES = ["qwen2_moe_a2_7b", "moonshot_v1_16b_a3b", "mamba2_780m",
            "recurrentgemma_2b", "whisper_tiny"]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, dtype="float32"):
    """The reduced config of ``arch`` in both packages, at ``dtype``."""
    return (dataclasses.replace(ref_configs.get_config(arch).reduced(),
                                dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    rb = ref_build(ref_configs.get_config(arch).reduced(), remat="none")
    return rb.init(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32"):
    """The reference's jitted bundle and parameters and the port's, the
    port carrying the reference's (f32 master) weights, on the CPU."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    rb = ref_build(ref_cfg, remat="none")
    rp = _ref_params(arch)
    rb = dataclasses.replace(
        rb, forward=fast_jit(rb.forward),
        prefill_fn=fast_jit(rb.prefill_fn, static_argnums=2),
        decode_fn=fast_jit(rb.decode_fn))
    port = build(cfg, remat="none", device="cpu")
    params = from_numpy_params(cfg, jax.tree.map(np.asarray, rp), "cpu")
    return rb, rp, port, params


def _prompt(batch, s_prompt):
    prompt = dict(batch)
    prompt["tokens"] = batch["tokens"][:, :s_prompt]
    return prompt


# ----------------------------------------------------- whole models ----

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match_reference(arch):
    """f32: forward, prefill (logits and every cache entry) and three
    decode steps (logits and the cache after them)."""
    rb, rp, port, params = _models(arch)
    s_total, s_prompt = 10, 7
    batch = rb.make_batch(3, ShapeSpec("c", s_total, 2, "train"), train=False)
    ours_batch = port.make_batch(3, ShapeSpec("c", s_total, 2, "train"),
                                 train=False)
    assert batch.keys() == ours_batch.keys()
    assert all(np.array_equal(batch[k], ours_batch[k]) for k in batch)
    with torch.no_grad():
        np.testing.assert_allclose(_np(port.forward(params, batch)),
                                   _np(rb.forward(rp, batch)), **F32)
    prompt = _prompt(batch, s_prompt)
    logits, cache = port.prefill_fn(params, prompt, s_total)
    rlogits, rcache = rb.prefill_fn(rp, prompt, s_total)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **F32)
    assert cache.keys() == rcache.keys()
    for name in rcache:
        assert tuple(cache[name].shape) == rcache[name].shape, name
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   **F32, err_msg=name)
    for pos in range(s_prompt, s_total):
        tok = batch["tokens"][:, pos:pos + 1]
        logits, cache = port.decode_fn(params, cache, tok, pos)
        rlogits, rcache = rb.decode_fn(rp, rcache, tok, jnp.int32(pos))
        np.testing.assert_allclose(_np(logits), _np(rlogits), **F32,
                                   err_msg=f"{arch} decode@{pos}")
    for name in rcache:
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   **F32, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_forward_prefill_decode_match_reference(arch):
    """bf16 compute on the same f32 master weights: forward, prefill logits
    and one decode step within 5e-2."""
    rb, rp, port, params = _models(arch, "bfloat16")
    batch = rb.make_batch(4, ShapeSpec("c", 8, 2, "train"), train=False)
    with torch.no_grad():
        got = port.forward(params, batch)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(rb.forward(rp, batch)), **BF16)
    prompt = _prompt(batch, 7)
    logits, cache = port.prefill_fn(params, prompt, 8)
    rlogits, rcache = rb.prefill_fn(rp, prompt, 8)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **BF16)
    tok = batch["tokens"][:, 7:8]
    logits, _ = port.decode_fn(params, cache, tok, 7)
    rlogits, _ = rb.decode_fn(rp, rcache, tok, jnp.int32(7))
    np.testing.assert_allclose(_np(logits), _np(rlogits), **BF16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_has_the_reference_s_tree(arch):
    """The port's own random parameters: the reference's names and
    shapes, f32, seeded."""
    _, cfg = _cfgs(arch)
    bundle = build(cfg, device="cpu")
    sd = bundle.init(torch.Generator().manual_seed(7)).state_dict()
    again = bundle.init(torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    assert all(v.dtype == torch.float32 for v in sd.values())
    ref = {"__".join(str(getattr(p, "key", p)) for p in path): leaf.shape
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               _ref_params(arch))[0]}
    assert ref == {k.replace(".", "__"): tuple(v.shape)
                   for k, v in sd.items()}


@pytest.mark.parametrize("arch", ARCH_IDS + EXTRA_IDS)
def test_every_config_builds_and_runs(arch):
    """All twelve configs build on the CPU; the reduced model's forward,
    prefill and one decode step give finite logits of the padded vocab."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = bundle.make_batch(0, ShapeSpec("s", 8, 2, "train"), train=False)
    with torch.no_grad():
        logits = bundle.forward(params, batch)
    assert tuple(logits.shape) == (2, 8, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    _, cache = bundle.prefill_fn(params, batch, 12)
    step, _ = bundle.decode_fn(params, cache, batch["tokens"][:, -1:], 8)
    assert tuple(step.shape) == (2, cfg.padded_vocab)
    assert torch.isfinite(step[:, :cfg.vocab_size]).all()
    empty = bundle.init_cache(2, 12)
    assert empty.keys() == cache.keys()


# -------------------------------------------------------- MoE routing ----

def _ref_routing(monkeypatch, x, lp, cfg):
    """The reference's moe_ffn, jitted, returning beside its output the
    top-k selection and the slots it computes on the way (spies on
    ``lax.top_k`` and ``_combine`` while it traces)."""
    seen = {}
    top_k, combine = jax.lax.top_k, RM._combine

    def spy_top_k(operand, k):
        seen["gate_vals"], seen["sel"] = top_k(operand, k)
        return seen["gate_vals"], seen["sel"]

    def spy_combine(out_flat, slot, n_slots):
        seen["slot"], seen["n_slots"] = slot, n_slots
        return combine(out_flat, slot, n_slots)

    def run(x, lp):
        out = RM.moe_ffn(x, lp, cfg)
        return out, seen["gate_vals"], seen["sel"], seen["slot"]

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(RM, "_combine", spy_combine)
    out, gate_vals, sel, slot = jax.jit(run)(jnp.asarray(x),
                                             jax.tree.map(jnp.asarray, lp))
    monkeypatch.undo()
    return out, dict(gate_vals=gate_vals, sel=sel, slot=slot,
                     n_slots=seen["n_slots"])


ROUTING = {
    # reduced qwen: 4 experts padded to 16, generous capacity (no drop)
    "generous": (dict(), 10, None),
    # capacity 10 for 80 assignments over 4 experts: many dropped
    "overflow": (dict(capacity_factor=0.5), 40, None),
    # experts 1 and 2 score the same on every token
    "ties": (dict(), 12, (1, 2)),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_moe_routing_equals_reference(case, monkeypatch):
    """Each token's experts in order, the kept assignments and their
    slots equal the reference's exactly; gates and the layer's output
    within f32 tolerance."""
    changes, s, tie = ROUTING[case]
    ref_cfg, cfg = (dataclasses.replace(c, **changes)
                    for c in _cfgs("qwen2_moe_a2_7b"))
    lp = jax.tree.map(lambda a: np.array(a[0]),
                      _ref_params("qwen2_moe_a2_7b")["layers"])
    if tie:
        lp["router"][:, tie[1]] = lp["router"][:, tie[0]]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want, seen = _ref_routing(monkeypatch, x, lp, ref_cfg)
    tlp = jax.tree.map(torch.from_numpy, lp)
    sel, gates, slot, cap = moe.route(torch.from_numpy(x), tlp["router"],
                                      cfg)
    e = moe.padded_experts(cfg)
    assert e * cap == seen["n_slots"]
    np.testing.assert_array_equal(sel.numpy(), np.asarray(seen["sel"]))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(seen["slot"]))
    dropped = int((slot == e * cap).sum())
    if case == "overflow":
        assert dropped > 0
    else:
        assert dropped == 0
    if tie:  # where both tied experts are chosen, the lower index first
        both = (sel == tie[0]).any(-1) & (sel == tie[1]).any(-1)
        assert both.any()
        rank = [(sel == t).int().argmax(-1)[both] for t in tie]
        assert (rank[0] < rank[1]).all()
    ref_gates = jax.nn.softmax(seen["gate_vals"], axis=-1)
    np.testing.assert_allclose(gates.numpy(), _np(ref_gates), **F32)
    with torch.no_grad():
        got = moe.moe_ffn(torch.from_numpy(x), tlp, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ------------------------------- the reference's test_models_smoke.py cases --

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch):
    """Decode continuation must reproduce teacher-forced forward logits."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    s_total, s_prompt = 12, 6
    batch = bundle.make_batch(3, ShapeSpec("c", s_total, 2, "train"),
                              train=False)
    with torch.no_grad():
        logits_full = _np(bundle.forward(params, batch))
    prompt = _prompt(batch, s_prompt)
    p_logits, cache = bundle.prefill_fn(params, prompt, s_total)
    np.testing.assert_allclose(_np(p_logits), logits_full[:, :s_prompt],
                               rtol=2e-3, atol=2e-3)
    for pos in range(s_prompt, s_total):
        tok = batch["tokens"][:, pos:pos + 1]
        d_logits, cache = bundle.decode_fn(params, cache, tok, pos)
        np.testing.assert_allclose(
            _np(d_logits), logits_full[:, pos],
            rtol=5e-3, atol=5e-3,
            err_msg=f"{arch} decode@{pos} diverges from forward")


def test_mamba2_chunking_invariance():
    """SSD chunked computation must not depend on the chunk size."""
    cfg = get_config("mamba2_780m").reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = bundle.make_batch(0, ShapeSpec("c", 24, 2, "train"), train=False)
    outs = []
    for chunk in (8, 24):
        b2 = build(dataclasses.replace(cfg, ssm_chunk=chunk), remat="none",
                   device="cpu")
        with torch.no_grad():
            outs.append(_np(b2.forward(params, batch)))
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-3, atol=2e-3)


def test_ring_kv_cache_decode_matches_forward():
    """recurrentgemma's ring KV cache: decode through the ring's
    wrap-around must still match the teacher-forced forward."""
    L.set_ring_kv(True)
    try:
        cfg = get_config("recurrentgemma_2b").reduced()
        bundle = build(cfg, remat="none", device="cpu")
        params = bundle.init(torch.Generator().manual_seed(0))
        s_total, s_prompt = 40, 20  # window 16 < prompt: the ring wraps
        batch = bundle.make_batch(3, ShapeSpec("r", s_total, 2, "train"),
                                  train=False)
        with torch.no_grad():
            full = _np(bundle.forward(params, batch))
        prompt = {"tokens": batch["tokens"][:, :s_prompt]}
        p_logits, cache = bundle.prefill_fn(params, prompt, s_total)
        np.testing.assert_allclose(_np(p_logits), full[:, :s_prompt],
                                   rtol=3e-3, atol=3e-3)
        # the allocation really is window-sized
        assert cache["k"].shape[2] == 16
        for pos in range(s_prompt, s_total):
            tok = batch["tokens"][:, pos:pos + 1]
            lg, cache = bundle.decode_fn(params, cache, tok, pos)
            np.testing.assert_allclose(_np(lg), full[:, pos], rtol=6e-3,
                                       atol=6e-3,
                                       err_msg=f"ring decode@{pos}")
    finally:
        L.set_ring_kv(False)
