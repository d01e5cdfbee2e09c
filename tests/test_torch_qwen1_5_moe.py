"""Qwen1.5-MoE-A2.7B as published (``configs/qwen1_5_moe_a2_7b.py``) against
the plain reference (``tests/_qwen1_5_moe_reference.py``), on the CPU at a
small size in float32, on seeded random weights:

- the ``Server``'s prefill and every decode step give the reference's
  logits;
- under a router that sends every token to one expert the dropless path
  drops nothing and still gives the reference's logits, and it never reads
  an expert that no token chose;
- each of the four switches (``qkv_bias``, ``shared_expert_gate``,
  ``norm_topk_prob``, ``moe_dropless``) turned back alone breaks the
  agreement;
- the config holds the published values;
- the serving and MoE spans and counters are recorded, ``moe.dropped`` 0
  on the dropless path and above 0 where capacity drops.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _qwen1_5_moe_reference import forward as reference
from repro_torch import tracing
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config
from repro_torch.models import moe
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

torch.set_num_threads(1)

# Both sides compute in float32; they sum in other orders (the port's
# attention is an online softmax over key chunks, its experts run sorted by
# expert and are summed per token) and the port's RoPE angles are float32
# where the reference's are float64: differences of a few float32 roundings
# of logits of order 1, well under 1e-4.
TOL = dict(rtol=1e-4, atol=1e-4)
# A switch turned back moves the logits by more than this many tolerances.
MOVES = 100

PROMPT, STEPS = 9, 5


def small(**changes):
    """The published config at a small size: 2 layers of width 64, 16
    experts of 32 (none padded on any path), top-4, one shared expert of
    32, the published capacity factor for the capacity path."""
    cfg = dataclasses.replace(get_config("qwen1_5_moe_a2_7b").reduced(),
                              n_experts=16, top_k=4, capacity_factor=1.25)
    return dataclasses.replace(cfg, **changes)


def model_of(cfg) -> dict:
    """The reference's config.json keys of ``cfg``."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "num_experts": cfg.n_experts, "num_experts_per_tok": cfg.top_k,
            "moe_intermediate_size": cfg.moe_d_ff,
            "shared_expert_intermediate_size":
                cfg.n_shared_experts * cfg.moe_d_ff,
            "norm_topk_prob": cfg.norm_topk_prob,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "vocab_size": cfg.vocab_size}


def weights(cfg, seed=3, skew=False):
    """The port's parameters of ``cfg`` as a nested dict of tensors. With
    ``skew`` every token's first choice is expert 0 in every layer: one
    dimension of every embedding is large, so it leads every normalised
    hidden state with the same sign, and expert 0's router column reads
    it."""
    params = cast_params(build(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed)), torch.float32)
    if skew:
        with torch.no_grad():
            params["embedding"][:, 0] = 100.0
            params["layers"]["router"][:, 0, 0] = 10.0
    return params


def prompts(cfg, b=3, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, PROMPT)).astype(np.int32)


def decode(cfg, params, ids, steps=STEPS):
    """The Server's prefill and ``steps`` steps: every row's fed tokens
    (B, PROMPT + steps) and the logits of the prefill's last position and
    of each step, (B, steps + 1, V)."""
    server = Server(build(cfg, device="cpu"), params, max_len=PROMPT + steps)
    state = server.prefill(ids)
    logits, fed = [state.logits], [state.tokens]
    for _ in range(steps):
        fed.append(server.step(state))
        logits.append(state.logits)
    seq = np.concatenate([ids, np.stack(fed[:-1], axis=1)], axis=1)
    return seq, torch.stack(logits, dim=1)


def want_logits(cfg, params, seq):
    """The reference's logits at the positions the decode produced."""
    return reference(model_of(cfg), params, seq)[:, PROMPT - 1:]


def test_server_prefill_and_decode_steps_equal_the_reference():
    cfg = small()
    params = weights(cfg)
    seq, got = decode(cfg, params, prompts(cfg))
    want = want_logits(cfg, params, seq)
    assert got.shape == want.shape == (3, STEPS + 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_dropless_under_skewed_routing(monkeypatch):
    """Every token's first expert is expert 0: no assignment is dropped,
    and the logits are the reference's."""
    cfg = small()
    params = weights(cfg, skew=True)
    firsts = []
    real_top_k = moe.top_k

    def spy_top_k(logits, cfg_):
        sel, gates = real_top_k(logits, cfg_)
        firsts.append(sel[..., 0])
        return sel, gates

    monkeypatch.setattr(moe, "top_k", spy_top_k)
    tracing.reset_counters("moe.")
    seq, got = decode(cfg, params, prompts(cfg))
    counts = tracing.counters()
    assert len(firsts) == cfg.n_layers * (1 + STEPS)
    assert all((first == 0).all() for first in firsts)
    assert counts["moe.dropped"] == 0
    assert counts["moe.assignments"] == cfg.n_layers * (
        3 * PROMPT + 3 * STEPS) * cfg.top_k
    np.testing.assert_allclose(got.numpy(),
                               want_logits(cfg, params, seq).numpy(), **TOL)


def layer0(params) -> dict:
    return {k: (v[0] if not isinstance(v, dict) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in params["layers"].items()}


def test_dropless_reads_only_the_chosen_experts():
    """A step's experts that no row chose are never read: with their
    weights NaN the layer's output is unchanged (a NaN read would spread),
    and the experts counted while recording are the chosen ones."""
    cfg = small()
    layer = layer0(weights(cfg))
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    with torch.no_grad():
        sel, _ = moe.top_k((x @ layer["router"]).float(), cfg)
        chosen = sorted(set(sel.reshape(-1).tolist()))
        want = moe.moe_ffn(x, layer, cfg)

        def poisoned(experts):
            out = dict(layer, experts={n: w.clone() for n, w in
                                       layer["experts"].items()})
            for w in out["experts"].values():
                w[experts] = float("nan")
            return out

        unchosen = [e for e in range(cfg.n_experts) if e not in chosen]
        assert 0 < len(chosen) < cfg.n_experts
        tracing.reset_counters("moe.")
        tracing.enable()
        try:
            got = moe.moe_ffn(x, poisoned(unchosen), cfg)
        finally:
            tracing.disable()
            tracing.collect()
        assert torch.equal(got, want)
        assert tracing.counters()["moe.experts_read"] == len(chosen)
        assert torch.isnan(moe.moe_ffn(x, poisoned(chosen[:1]), cfg)).any()


@pytest.mark.parametrize("switch", ["qkv_bias", "shared_expert_gate",
                                    "norm_topk_prob", "moe_dropless"])
def test_each_switch_turned_back_alone_breaks_agreement(switch):
    """Capacity drops only where routing is skewed (at the published 1.25,
    evenly routed tokens fit), so ``moe_dropless`` is turned back on the
    skewed weights; there one expert takes nearly all of a token's weight,
    which would hide a renormalisation, so the others are turned back on
    the plain ones."""
    published = small()
    turned = small(**{switch: not getattr(published, switch)})
    params = weights(published, skew=switch == "moe_dropless")
    ids = prompts(published)
    seq, good = decode(published, params, ids)
    want = want_logits(published, params, seq)
    np.testing.assert_allclose(good.numpy(), want.numpy(), **TOL)
    with torch.no_grad():
        got = build(turned, device="cpu").forward(params, {"tokens": seq})
    off = (got[:, PROMPT - 1:] - want).abs().max()
    assert off > MOVES * TOL["atol"], (switch, float(off))


def test_config_holds_the_published_values():
    cfg = get_config("qwen1_5_moe_a2_7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (24, 2048, 16, 16, 128)
    assert cfg.qkv_bias and cfg.rope_theta == 1e6 and cfg.norm_eps == 1e-6
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff) == (60, 4, 1408)
    assert cfg.norm_topk_prob is False and cfg.moe_dropless
    assert cfg.shared_expert_gate
    assert cfg.n_shared_experts * cfg.moe_d_ff == cfg.d_ff == 5632
    assert cfg.act == "silu" and not cfg.tie_embeddings
    assert (cfg.vocab_size, cfg.max_seq_len, cfg.dtype) == (
        151936, 8192, "bfloat16")
    assert moe.padded_experts(cfg) == 60
    assert round(cfg.num_params() / 1e9, 2) == 14.32
    # the JAX package has no such config: it stays out of the lists the
    # parity tests pair with it
    assert "qwen1_5_moe_a2_7b" not in ARCH_IDS + EXTRA_IDS
    shapes = build(cfg, device="meta").init(None)
    assert tuple(shapes.layers.experts.w_gate.shape) == (24, 60, 2048, 1408)
    assert tuple(shapes.layers.shared_gate.shape) == (24, 2048, 1)
    assert tuple(shapes.layers.attn.bq.shape) == (24, 2048)


def test_spans_and_counters_are_recorded():
    cfg = small()
    params = weights(cfg)
    tracing.collect()
    tracing.reset_counters("moe.")
    tracing.enable()
    try:
        decode(cfg, params, prompts(cfg, b=2), steps=2)
    finally:
        tracing.disable()
    spans = tracing.collect()
    names = [s.name for s in spans]
    for name in ("serve.prefill", "serve.step", "moe.ffn", "moe.route",
                 "moe.experts", "moe.shared", "attention.decode"):
        assert name in names, name
    assert names.count("serve.step") == 2
    assert names.count("moe.ffn") == cfg.n_layers * 3
    assert names.count("attention.decode") == cfg.n_layers * 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("moe.route", "moe.experts", "moe.shared"):
            assert by_id[s.parent].name == "moe.ffn"
        if s.name == "moe.ffn":
            assert by_id[s.parent].name in ("serve.prefill", "serve.step")
    counts = tracing.counters()
    assert counts["moe.dropped"] == 0
    assert counts["moe.assignments"] == cfg.n_layers * (
        2 * PROMPT + 2 * 2) * cfg.top_k
    assert 0 < counts["moe.experts_read"] <= cfg.n_layers * 3 * cfg.n_experts


def test_capacity_path_counts_its_drops_while_recording():
    """The JAX package's copy routes with capacity: at a factor of 0.5 it
    drops, and ``moe.dropped`` counts them while spans are recorded (the
    count waits for the card) and not otherwise."""
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b").reduced(),
                              capacity_factor=0.5)
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    fwd = build(cfg, device="cpu").forward
    tracing.reset_counters("moe.")
    with torch.no_grad():
        fwd(params, {"tokens": ids})
    assert tracing.counters()["moe.dropped"] == 0
    assert tracing.counters()["moe.experts_read"] == \
        cfg.n_layers * moe.padded_experts(cfg)
    tracing.enable()
    try:
        with torch.no_grad():
            fwd(params, {"tokens": ids})
    finally:
        tracing.disable()
        tracing.collect()
    assert tracing.counters()["moe.dropped"] > 0


@pytest.mark.parametrize("at", [PROMPT, PROMPT + STEPS - 1])
def test_a_position_held_on_the_device_gives_the_same_step(at):
    """A decode step fed its position as a device tensor (what a step
    captured as a CUDA graph reads) writes the same cache slot and gives
    the same logits, bit for bit, as one fed the position as an int."""
    cfg = small()
    params = weights(cfg)
    bundle = build(cfg, device="cpu")
    ids = prompts(cfg)
    tok = torch.as_tensor(ids[:, :1])
    out = []
    for pos in (at, torch.tensor(at, dtype=torch.int32)):
        _, cache = bundle.prefill_fn(params, {"tokens": ids},
                                     PROMPT + STEPS)
        logits, cache = bundle.decode_fn(params, cache, tok, pos)
        out.append((logits, cache))
    (want, want_cache), (got, got_cache) = out
    assert torch.equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(got_cache[name], want_cache[name])
        assert got_cache[name][:, :, at].abs().sum() > 0
