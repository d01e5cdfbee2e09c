"""The port's configs and dense/vlm model zoo against the JAX package's, on
the CPU (the other families: tests/test_torch_model_families.py).

- Every port config equals the reference's ``CONFIG``, field by field, and
  so does its ``reduced()``; ``ARCH_IDS`` and ``EXTRA_IDS`` are the
  reference's.
- The layers on the same numpy inputs: ``rms_norm``, ``apply_rope``,
  ``apply_mrope``, ``_sdpa`` with a window and with more keys than
  ``ATTN_CHUNK``, ``attention`` and ``attention_decode`` (plain, window
  sliced and ring).
- ``forward``, ``prefill`` and ``decode_step`` at ``reduced()`` of six
  configs, and one block at MobileLLM-125M's full widths (9 query and 3 KV
  heads) at seq 64, on the reference's weights carried across with
  ``from_numpy_params``: f32 within rtol 1e-4 / atol 1e-4, bf16 5e-2.
- The reference's test_models_smoke.py cases for the dense and vlm archs,
  with their assertions: prefill->decode against the teacher-forced
  forward, the window pattern, the masked vocab padding, the ring KV cache.
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
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import (build,  # noqa: E402
                                          from_numpy_params)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
DENSE_VLM = [a for a in ARCH_IDS if get_config(a).family in ("dense", "vlm")]
PARITY = ["mobilellm_125m", "yi_6b", "gemma3_1b", "h2o_danube_1_8b",
          "qwen2_vl_7b", "bert_tiny"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jit(fn):
    """The reference's function jitted, its non-array arguments static: one
    compile per call instead of one per operation."""
    def run(*args):
        static = [i for i, a in enumerate(args)
                  if not isinstance(a, (np.ndarray, jax.Array, dict))]
        return fast_jit(fn, static_argnums=static)(*args)
    return run


@functools.lru_cache(maxsize=None)
def _models(arch):
    """The reference's bundle and parameters and the port's, the port's
    carrying the reference's weights, on the CPU: built, initialised and
    jitted once per arch and shared by the tests that read them."""
    cfg = get_config(arch).reduced()
    rb = ref_build(ref_configs.get_config(arch).reduced(), remat="none")
    rp = rb.init(jax.random.key(0))
    # jitted: an eager lax.scan compiles its body again at every call
    rb = dataclasses.replace(
        rb, forward=fast_jit(rb.forward), loss_fn=fast_jit(rb.loss_fn),
        prefill_fn=fast_jit(rb.prefill_fn, static_argnums=2),
        decode_fn=fast_jit(rb.decode_fn))
    port = build(cfg, remat="none", device="cpu")
    params = from_numpy_params(cfg, jax.tree.map(np.asarray, rp), "cpu")
    return rb, rp, port, params


# --------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS + ref_configs.EXTRA_IDS)
def test_config_equals_reference(arch):
    ours, theirs = get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())


def test_arch_ids_are_the_reference_s():
    assert ARCH_IDS == ref_configs.ARCH_IDS
    assert EXTRA_IDS == ref_configs.EXTRA_IDS
    assert configs.SHAPES == {k: ShapeSpec(**dataclasses.asdict(v))
                              for k, v in ref_configs.SHAPES.items()}


# ---------------------------------------------------------------- layers ----

@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm_and_layer_norm(dtype, tol):
    rng = np.random.default_rng(0)
    x, scale, bias = _rand(rng, 2, 5, 64), _rand(rng, 64), _rand(rng, 64)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = L.rms_norm(_t(x).to(tdt), _t(scale), 1e-6)
    want = _jit(RL.rms_norm)(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    got = L.layer_norm(_t(x).to(tdt), _t(scale), _t(bias))
    want = _jit(RL.layer_norm)(jnp.asarray(x, dtype), jnp.asarray(scale),
                               jnp.asarray(bias))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_apply_rope_and_mrope():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(x), _t(pos), 10000.0)),
        _np(_jit(RL.apply_rope)(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        **F32)
    mpos = rng.integers(0, 500, (2, 3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.apply_mrope(_t(x), _t(mpos), 1e6, (4, 2, 2))),
        _np(_jit(RL.apply_mrope)(jnp.asarray(x), jnp.asarray(mpos), 1e6,
                                 (4, 2, 2))), **F32)


@pytest.mark.parametrize("t,window", [(40, -1), (40, 7), (1100, -1),
                                      (1100, 300)])
def test_sdpa_chunked_windowed_gqa(t, window):
    """Windows, GQA (4 query heads on 2 KV heads) and more keys than one
    chunk of ATTN_CHUNK (padded with sentinel columns)."""
    assert L.ATTN_CHUNK == RL.ATTN_CHUNK == 1024
    rng = np.random.default_rng(t + window)
    s = 6
    q, k, v = _rand(rng, 1, s, 4, 8), _rand(rng, 1, t, 2, 8), \
        _rand(rng, 1, t, 2, 8)
    rows = np.arange(t - s, t, dtype=np.int32)
    cols = np.arange(t, dtype=np.int32)
    got = L._sdpa(_t(q), _t(k), _t(v), _t(rows), _t(cols), window=window)
    want = jax.jit(RL._sdpa, static_argnums=5)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows),
        jnp.asarray(cols), window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_causal_window_mask():
    got = L.causal_window_mask(5, 9, 3, offset=4).numpy()
    want = np.asarray(RL.causal_window_mask(5, 9, 3, offset=4))
    np.testing.assert_array_equal(got, want)


def _attn_params(cfg, rng):
    return {"wq": _rand(rng, cfg.d_model, cfg.q_dim),
            "wk": _rand(rng, cfg.d_model, cfg.kv_dim),
            "wv": _rand(rng, cfg.d_model, cfg.kv_dim),
            "wo": _rand(rng, cfg.q_dim, cfg.d_model)}


def test_attention_full_sequence():
    cfg = get_config("yi_6b").reduced()
    rng = np.random.default_rng(2)
    p = _attn_params(cfg, rng)
    x = _rand(rng, 2, 9, cfg.d_model) * 0.1
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    out, (k, v) = L.attention(_t(x), {n: _t(a) for n, a in p.items()}, cfg,
                              _t(pos.copy()), window=4)
    rout, (rk, rv) = jax.jit(RL.attention, static_argnums=(2, 4))(
        jnp.asarray(x), p, cfg, jnp.asarray(pos), 4)
    for a, b in ((out, rout), (k, rk), (v, rv)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


@pytest.mark.parametrize("mode", ["plain", "window_slicing", "ring"])
def test_attention_decode(mode):
    """One decode step into a half-written cache: the written rows and the
    output equal the reference's, the port writing its cache in place."""
    cfg = get_config("h2o_danube_1_8b").reduced()  # window 16 everywhere
    rng = np.random.default_rng(3)
    p = _attn_params(cfg, rng)
    t = 16 if mode == "ring" else 24
    pos = 21 if mode == "ring" else 19  # the ring wraps: slot 5
    kc, vc = (_rand(rng, 2, t, cfg.n_kv_heads, cfg.head_dim)
              for _ in range(2))
    x = _rand(rng, 2, 1, cfg.d_model) * 0.1
    static = 16 if mode != "plain" else None
    L.set_decode_window_slicing(mode == "window_slicing")
    RL.set_decode_window_slicing(mode == "window_slicing")
    try:
        k_cache, v_cache = _t(kc.copy()), _t(vc.copy())
        out, k2, v2 = L.attention_decode(
            _t(x), {n: _t(a) for n, a in p.items()}, cfg, k_cache, v_cache,
            pos, window=16, static_window=static, ring=mode == "ring")
        rout, rk, rv = jax.jit(
            RL.attention_decode,
            static_argnames=("cfg", "static_window", "ring"))(
            jnp.asarray(x), p, cfg, jnp.asarray(kc), jnp.asarray(vc),
            jnp.int32(pos), 16, static_window=static, ring=mode == "ring")
    finally:
        L.set_decode_window_slicing(False)
        RL.set_decode_window_slicing(False)
    assert k2 is k_cache and v2 is v_cache  # written in place
    np.testing.assert_allclose(_np(out), _np(rout), **F32)
    np.testing.assert_allclose(_np(k_cache), _np(rk), **F32)
    np.testing.assert_allclose(_np(v_cache), _np(rv), **F32)


def test_ring_store_and_positions():
    cfg = get_config("h2o_danube_1_8b").reduced()
    rng = np.random.default_rng(4)
    k = _rand(rng, 2, 20, 2, 4)
    L.set_ring_kv(True)
    RL.set_ring_kv(True)
    try:
        assert L.ring_cache_len(cfg, 40) == RL.ring_cache_len(cfg, 40) == 16
        np.testing.assert_array_equal(
            L.ring_store(_t(k), cfg, 40).numpy(),
            np.asarray(RL.ring_store(jnp.asarray(k), cfg, 40)))
    finally:
        L.set_ring_kv(False)
        RL.set_ring_kv(False)
    np.testing.assert_array_equal(L.ring_positions(21, 16).numpy(),
                                  np.asarray(RL.ring_positions(21, 16)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_embed_unembed_and_loss(act):
    cfg = dataclasses.replace(get_config("gemma3_1b").reduced(),
                              vocab_size=250, act=act)  # padded to 256
    rng = np.random.default_rng(5)
    p = {"w_up": _rand(rng, 64, 128), "w_down": _rand(rng, 128, 64),
         "w_gate": _rand(rng, 64, 128)}
    x = _rand(rng, 2, 3, 64) * 0.1
    np.testing.assert_allclose(
        _np(L.mlp(_t(x), {n: _t(a) for n, a in p.items()}, act)),
        _np(_jit(RL.mlp)(jnp.asarray(x), jax.tree.map(jnp.asarray, p), act)),
        **F32)
    emb = {"embedding": _rand(rng, cfg.padded_vocab, 64) * 0.1}
    tokens = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    got = L.embed(_t(tokens), {"embedding": _t(emb["embedding"])}, cfg,
                  torch.float32)
    want = _jit(RL.embed)(jnp.asarray(tokens), emb, cfg,
                          jnp.float32)  # x sqrt(d)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    logits = L.unembed(got, {"embedding": _t(emb["embedding"])}, cfg)
    rlogits = _jit(RL.unembed)(want, emb, cfg)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **F32)
    assert (_np(logits)[..., cfg.vocab_size:] < -1e29).all()
    labels = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(L.lm_loss(logits, _t(labels),
                            None if m is None else _t(m))),
            float(_jit(RL.lm_loss)(rlogits, jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m))),
            **F32)


# ----------------------------------------------------- whole models ----

@pytest.mark.parametrize("arch", PARITY)
def test_forward_prefill_decode_match_reference(arch):
    """forward, prefill (logits and the cache) and three decode steps of the
    port equal the reference's at reduced() on the same weights."""
    rb, rp, port, params = _models(arch)
    s_total, s_prompt = 10, 7
    batch = rb.make_batch(3, ShapeSpec("c", s_total, 2, "train"), train=False)
    assert all(np.array_equal(a, b) for a, b in zip(
        batch.values(), port.make_batch(
            3, ShapeSpec("c", s_total, 2, "train"), train=False).values()))
    with torch.no_grad():
        np.testing.assert_allclose(_np(port.forward(params, batch)),
                                   _np(rb.forward(rp, batch)), **F32)
    prompt = {k: v for k, v in batch.items()}
    prompt["tokens"] = batch["tokens"][:, :s_prompt]
    if "mrope_positions" in prompt:
        prompt["mrope_positions"] = prompt["mrope_positions"][:, :, :s_prompt]
    logits, cache = port.prefill_fn(params, prompt, s_total)
    rlogits, rcache = rb.prefill_fn(rp, prompt, s_total)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]), **F32)
    for pos in range(s_prompt, s_total):
        tok = batch["tokens"][:, pos:pos + 1]
        logits, cache = port.decode_fn(params, cache, tok, pos)
        rlogits, rcache = rb.decode_fn(rp, rcache, tok, jnp.int32(pos))
        np.testing.assert_allclose(_np(logits), _np(rlogits), **F32,
                                   err_msg=f"{arch} decode@{pos}")


def test_loss_fn_matches_reference():
    rb, rp, port, params = _models("mobilellm_125m")
    train = rb.make_batch(4, ShapeSpec("c", 8, 2, "train"))
    with torch.no_grad():
        np.testing.assert_allclose(float(port.loss_fn(params, train)),
                                   float(rb.loss_fn(rp, train)), **F32)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_mobilellm_block_at_full_width(dtype, tol):
    """One transformer block of MobileLLM-125M unreduced (d_model 576, 9
    query and 3 KV heads of 64, d_ff 1536) at seq 64: the GQA head order
    and the widths the reduced configs do not have."""
    cfg = dataclasses.replace(get_config("mobilellm_125m"), dtype=dtype)
    rng = np.random.default_rng(6)
    d, f = cfg.d_model, cfg.d_ff
    lp = {"ln1": 1 + 0.1 * _rand(rng, d), "ln2": 1 + 0.1 * _rand(rng, d),
          "attn": {n: a / np.sqrt(a.shape[0])
                   for n, a in _attn_params(cfg, rng).items()},
          "mlp": {"w_up": _rand(rng, d, f) / 24, "w_gate": _rand(rng, d, f) / 24,
                  "w_down": _rand(rng, f, d) / 40}}
    x = _rand(rng, 1, 64, d)
    pos = np.arange(64, dtype=np.int32)[None]
    tdt = T.DTYPES[dtype]
    with torch.no_grad():
        got = T._block(_t(x).to(tdt),
                       jax.tree.map(_t, lp), -1, cfg, _t(pos), None)
    want = jax.jit(RT._block, static_argnums=(3, 5))(
        jnp.asarray(x, dtype), lp, -1, cfg, jnp.asarray(pos), None)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_init_is_seeded_stacked_and_placed():
    cfg = get_config("yi_6b").reduced()
    bundle = build(cfg, device="cpu")
    a = bundle.init(torch.Generator().manual_seed(7))
    b = bundle.init(torch.Generator().manual_seed(7))
    sd = a.state_dict()
    assert sd["layers.attn.wq"].shape == (cfg.n_layers, cfg.d_model,
                                          cfg.q_dim)
    assert sd["embedding"].shape == (cfg.padded_vocab, cfg.d_model)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    tokens = torch.arange(6).reshape(1, 6)
    with torch.no_grad():  # calling the module is the functional forward
        assert torch.equal(a(tokens), bundle.forward(a, {"tokens": tokens}))
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in sd.values())
    rp = _models("yi_6b")[1]  # the reference's tree, initialised once
    names = {"__".join(str(getattr(p, "key", p)) for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]}
    assert names == {k.replace(".", "__") for k in sd}
    cache = bundle.init_cache(2, 12)
    assert cache["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                                cfg.head_dim)


# ------------------------------- the reference's test_models_smoke.py cases --

@pytest.mark.parametrize("arch", DENSE_VLM)
def test_prefill_decode_matches_forward(arch):
    """Decode continuation must reproduce teacher-forced forward logits."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    s_total, s_prompt = 12, 6
    batch = bundle.make_batch(3, ShapeSpec("c", s_total, 2, "train"),
                              train=False)
    full_inputs = dict(batch)
    if "mrope_positions" in full_inputs:
        full_inputs["mrope_positions"] = \
            full_inputs["mrope_positions"][:, :, :s_total]
    with torch.no_grad():
        logits_full = _np(bundle.forward(params, full_inputs))

    prompt = dict(batch)
    prompt["tokens"] = batch["tokens"][:, :s_prompt]
    if "mrope_positions" in prompt:
        prompt["mrope_positions"] = prompt["mrope_positions"][:, :, :s_prompt]
    if "patch_embeds" in prompt:
        prompt["patch_embeds"] = prompt["patch_embeds"][:, :2]
        full_inputs["patch_embeds"] = full_inputs["patch_embeds"][:, :2]
        with torch.no_grad():
            logits_full = _np(bundle.forward(params, full_inputs))
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


@pytest.mark.parametrize("arch", ["gemma3_1b", "h2o_danube_1_8b"])
def test_window_pattern_is_applied(arch):
    """Windowed attention must differ from full attention on long context."""
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = bundle.make_batch(0, ShapeSpec("w", 32, 1, "train"), train=False)
    full_cfg = dataclasses.replace(cfg, window_pattern=())
    bundle_full = build(full_cfg, remat="none", device="cpu")
    with torch.no_grad():
        a = _np(bundle.forward(params, batch))
        b = _np(bundle_full.forward(params, batch))
    assert np.abs(a - b).max() > 1e-4  # the window actually masks something


def test_vocab_padding_masked():
    """Padded vocab slots must never win argmax and carry ~zero prob."""
    cfg = get_config("granite_3_2b").reduced()  # 256 -> padded 256 (equal)
    cfg = dataclasses.replace(cfg, vocab_size=250)  # force padding
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(1))
    batch = bundle.make_batch(0, ShapeSpec("v", 16, 2, "train"), train=False)
    with torch.no_grad():
        logits = _np(bundle.forward(params, batch))
    assert logits.shape[-1] == cfg.padded_vocab
    assert (logits[..., cfg.vocab_size:] < -1e29).all()


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b"])
def test_ring_kv_cache_decode_matches_forward(arch):
    """Ring KV caches: decode through ring wrap-around must still match
    teacher-forced forward (the reference's hybrid case is in
    tests/test_torch_model_families.py)."""
    L.set_ring_kv(True)
    try:
        cfg = get_config(arch).reduced()
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
                                       err_msg=f"{arch} ring decode@{pos}")
    finally:
        L.set_ring_kv(False)
