"""Moonlight-16B-A3B as published (``configs/moonlight_16b_a3b.py``) against
the plain reference (``tests/_moonlight_16b_a3b_reference.py``), on the CPU
at a small size in float32, on seeded random weights:

- the ``Server``'s prefill and every decode step (the absorbed latent
  attention) give the reference's logits, and so does a prefill of its
  rows in groups;
- the absorbed form of a decode step equals the decompressed form of the
  same position;
- each switch turned back alone breaks the agreement: softmax scoring,
  the correction bias ignored, weights from the biased scores, no
  renormalisation, no routed scaling factor, layer 0 as a MoE layer, RoPE
  in half order, no RMSNorm of the latent row, the scale 1/sqrt(128);
- the config holds the published values, and a step fed its position as a
  device tensor is the same step;
- the spans and counters are recorded, and the decode state keeps each
  MoE layer's experts;
- on a card, graphed steps equal eager ones bit for bit.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from _moonlight_16b_a3b_reference import forward as reference
from repro_torch import tracing
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config
from repro_torch.models import layers as L
from repro_torch.models import mla, moe
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

torch.set_num_threads(1)

# Both sides compute in float32; they sum in other orders (the port's
# prefill attention is an online softmax over key chunks, its decode the
# absorbed form, its experts run sorted by expert) and the port's RoPE
# angles are float32 where the reference's are float64: differences of a
# few float32 roundings of logits of order 1, well under 1e-4.
TOL = dict(rtol=1e-4, atol=1e-4)
# A switch turned back moves the logits by more than this many tolerances.
MOVES = 100

PROMPT, STEPS = 9, 5
PUBLISHED = get_config("moonlight_16b_a3b")


def small(**changes):
    """The published config at the small size (``reduced``): a dense layer
    and two MoE layers of width 64, 4 heads of 16 + 8 over a latent row of
    32 + 8, 8 experts of 32 top-3, two shared experts."""
    return dataclasses.replace(PUBLISHED.reduced(), **changes)


def model_of(cfg) -> dict:
    """The reference's config.json keys of ``cfg``."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim,
            "n_routed_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "first_k_dense_replace": cfg.first_k_dense_replace,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}


def weights(cfg, seed=3):
    """The port's parameters of ``cfg`` as a nested dict of tensors, the
    correction bias drawn (a trained one's; the init's are 0) at a spread
    that moves some choices."""
    params = cast_params(build(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed)), torch.float32)
    if cfg.topk_method == "noaux_tc":
        with torch.no_grad():
            params["layers"]["router_bias"].normal_(
                0, 0.2, generator=torch.Generator().manual_seed(seed + 1))
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


def test_rows_prefilled_in_groups_equal_the_reference(monkeypatch):
    """More rows than ``moe.PREFILL_TOKENS`` tokens: the prefill takes them
    in groups into one cache, and the steps after it are the reference's."""
    cfg = small()
    params = weights(cfg)
    monkeypatch.setattr(moe, "PREFILL_TOKENS", 2 * PROMPT)
    seq, got = decode(cfg, params, prompts(cfg, b=5))
    np.testing.assert_allclose(got.numpy(),
                               want_logits(cfg, params, seq).numpy(), **TOL)


def test_absorbed_decode_equals_the_decompressed_form():
    """One layer's attention at the last of 12 positions: the decode step's
    absorbed form over the latent rows the prefill cached equals the
    decompressed form of the whole sequence at that position."""
    cfg = small()
    lp = moe.layer_stack(weights(cfg), cfg)[1][0]["attn"]
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    positions = torch.arange(12).expand(2, 12)
    with torch.no_grad():
        full, latent = mla.attention(x, lp, cfg, positions)
        cache = torch.zeros(2, 16, latent.shape[-1])
        cache[:, :11] = latent[:, :11]
        got = mla.attention_decode(x[:, 11:], lp, cfg, cache, 11)
    torch.testing.assert_close(got, full[:, 11:], **TOL)
    torch.testing.assert_close(cache[:, 11], latent[:, 11], **TOL)


def biased_weights(real):
    """``moe.top_k`` weighting the chosen experts by their biased scores."""
    def top_k(logits, cfg, *bias):
        sel, _ = real(logits, cfg, *bias)
        scores = torch.sigmoid(logits) + bias[0].float()
        gates = torch.gather(scores, -1, sel)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        return sel, gates * cfg.routed_scaling_factor
    return top_k


def half_order_rope(x, positions, theta):
    """RoPE by rotate-half on the rope dims as they lie."""
    freqs = L._rope_freqs_on(x.shape[-1], theta, x.device)
    return L._rotate(x, positions[..., None].float() * freqs)


def moe_first_layer(params):
    """Layer 0 as a MoE layer: its attention and norms, then the first MoE
    layer's router, experts and shared experts."""
    dense, layers = params["dense_layers"], params["layers"]

    def stack(name, node):
        if isinstance(node, dict):
            return {k: stack(k, v) for k, v in node.items()}
        return torch.cat([node[:1], node])
    out = {k: v for k, v in params.items() if k != "dense_layers"}
    out["layers"] = stack("layers", layers)
    for name in ("ln1", "ln2"):
        out["layers"][name][0] = dense[name][0]
    for name, w in dense["attn"].items():
        out["layers"]["attn"][name][0] = w[0]
    return out


SWITCHES = {
    "softmax scoring": ({"scoring_func": "softmax"}, None),
    "bias ignored": ({"topk_method": "greedy"}, None),
    "weights from biased scores": ({}, (moe, "top_k", biased_weights)),
    "no renormalisation": ({"norm_topk_prob": False}, None),
    "no routed scaling": ({"routed_scaling_factor": 1.0}, None),
    "layer 0 as MoE": ({"first_k_dense_replace": 0}, None),
    "RoPE in half order": ({}, (mla, "rope", lambda _: half_order_rope)),
    "no kv_a RMSNorm": ({}, (mla, "kv_norm", lambda _: lambda c, s: c)),
    "scale 1/sqrt(128)": ({}, (mla, "softmax_scale",
                               lambda _: lambda cfg: 1 / math.sqrt(128))),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_each_switch_turned_back_alone_breaks_agreement(switch,
                                                        monkeypatch):
    changes, patch = SWITCHES[switch]
    published = small()
    params = weights(published)
    ids = prompts(published)
    seq, good = decode(published, params, ids)
    want = want_logits(published, params, seq)
    np.testing.assert_allclose(good.numpy(), want.numpy(), **TOL)
    turned = small(**changes)
    if switch == "layer 0 as MoE":
        params = moe_first_layer(params)
    if patch is not None:
        module, name, make = patch
        monkeypatch.setattr(module, name, make(getattr(module, name)))
    with torch.no_grad():
        got = build(turned, device="cpu").forward(params, {"tokens": seq})
    off = (got[:, PROMPT - 1:] - want).abs().max()
    assert off > MOVES * TOL["atol"], (switch, float(off))


def test_config_holds_the_published_values():
    cfg = PUBLISHED
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads) == (27, 2048, 16)
    assert (cfg.kv_lora_rank, cfg.q_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (512, 0, 128, 64, 128)
    assert (cfg.first_k_dense_replace, cfg.dense_d_ff) == (1, 11264)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff,
            cfg.n_shared_experts) == (64, 6, 1408, 2)
    assert (cfg.scoring_func, cfg.topk_method) == ("sigmoid", "noaux_tc")
    assert cfg.routed_scaling_factor == 2.446 and cfg.norm_topk_prob
    assert cfg.moe_dropless and not cfg.shared_expert_gate
    assert cfg.rope_theta == 50000 and cfg.norm_eps == 1e-5
    assert cfg.act == "silu" and not cfg.tie_embeddings
    assert (cfg.vocab_size, cfg.max_seq_len, cfg.dtype) == (
        163840, 8192, "bfloat16")
    assert mla.softmax_scale(cfg) == 1 / math.sqrt(192)
    assert round(cfg.num_params() / 1e9, 2) == 15.96
    assert "moonlight_16b_a3b" not in ARCH_IDS + EXTRA_IDS
    shapes = build(cfg, device="meta").init(None)
    assert tuple(shapes.dense_layers.mlp.w_gate.shape) == (1, 2048, 11264)
    assert tuple(shapes.layers.experts.w_gate.shape) == (26, 64, 2048, 1408)
    assert tuple(shapes.layers.shared.w_gate.shape) == (26, 2048, 2816)
    assert tuple(shapes.layers.router_bias.shape) == (26, 64)
    attn = shapes.layers.attn
    assert tuple(attn.wq.shape) == (26, 2048, 16 * 192)
    assert tuple(attn.wkv_a.shape) == (26, 2048, 576)
    assert tuple(attn.wkv_b.shape) == (26, 512, 16 * 256)
    assert tuple(attn.wo.shape) == (26, 2048, 2048)
    cache = build(cfg, device="meta").init_cache(16, 8192)
    assert tuple(cache["latent"].shape) == (27, 16, 8192, 576)
    assert tuple(cache["experts"].shape) == (26, 16, 6)


def test_other_configs_keep_their_layer():
    """The new fields' defaults leave every other config as it was: no
    latent attention, no dense leading layer, softmax routing."""
    for arch in ARCH_IDS + EXTRA_IDS + ("qwen1_5_moe_a2_7b",):
        cfg = get_config(arch)
        assert not cfg.mla and cfg.first_k_dense_replace == 0, arch
        assert (cfg.scoring_func, cfg.topk_method,
                cfg.routed_scaling_factor) == ("softmax", "greedy", 1.0)
    assert round(get_config("qwen1_5_moe_a2_7b").num_params() / 1e9,
                 2) == 14.32


@pytest.mark.parametrize("at", [PROMPT, PROMPT + STEPS - 1])
def test_a_position_held_on_the_device_gives_the_same_step(at):
    """A decode step fed its position as a device tensor (what a step
    captured as a CUDA graph reads) writes the same latent row and gives
    the same logits, bit for bit, as one fed the position as an int."""
    cfg = small()
    params = weights(cfg)
    bundle = build(cfg, device="cpu")
    ids = prompts(cfg)
    tok = torch.as_tensor(ids[:, :1])
    out = []
    for pos in (at, torch.tensor(at, dtype=torch.int32)):
        _, cache = bundle.prefill_fn(params, {"tokens": ids}, PROMPT + STEPS)
        logits, cache = bundle.decode_fn(params, cache, tok, pos)
        out.append((logits, cache))
    (want, want_cache), (got, got_cache) = out
    assert torch.equal(got, want)
    for name in ("latent", "experts"):
        assert torch.equal(got_cache[name], want_cache[name])
    assert got_cache["latent"][:, :, at].abs().sum() > 0


def test_spans_counters_and_the_experts_kept():
    cfg = small()
    params = weights(cfg)
    tracing.collect()
    tracing.reset_counters("moe.")
    tracing.enable()
    try:
        server = Server(build(cfg, device="cpu"), params, max_len=PROMPT + 2)
        state = server.prefill(prompts(cfg, b=2))
        for _ in range(2):
            server.step(state)
    finally:
        tracing.disable()
    spans = tracing.collect()
    names = [s.name for s in spans]
    moe_layers = cfg.n_layers - cfg.first_k_dense_replace
    assert names.count("mla.prefill") == cfg.n_layers
    assert names.count("mlp.dense") == 3 * cfg.first_k_dense_replace
    assert names.count("moe.ffn") == 3 * moe_layers
    assert names.count("attention.decode") == 2 * cfg.n_layers
    for name in ("mla.absorb", "mla.out"):
        assert names.count(name) == 2 * cfg.n_layers
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("mla.absorb", "mla.out"):
            assert by_id[s.parent].name == "attention.decode"
        if s.name == "mlp.dense":
            assert by_id[s.parent].name in ("serve.prefill", "serve.step")
    counts = tracing.counters()
    assert counts["moe.dropped"] == 0
    assert counts["moe.assignments"] == moe_layers * (
        2 * PROMPT + 2 * 2) * cfg.top_k
    # the last step's experts, each layer's and row's: the routing of its
    # hidden states, as ``moe.top_k`` chooses
    kept = state.cache["experts"]
    assert tuple(kept.shape) == (moe_layers, 2, cfg.top_k)
    assert ((kept >= 0) & (kept < cfg.n_experts)).all()
    assert all(len(set(row.tolist())) == cfg.top_k
               for row in kept.reshape(-1, cfg.top_k))


@pytest.mark.gpu
@torch.no_grad()
def test_graphed_steps_equal_eager_steps_on_a_card():
    """At Moonlight's attention widths in bf16 (the latent and MoE decode
    kernels), a Server whose steps replay a CUDA graph gives the eager
    Server's logits and experts, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = small(dtype="bfloat16", kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, n_heads=16,
                n_kv_heads=16, head_dim=128, d_model=256)
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(4)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 40), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))
    runs = []
    for graphed in (False, True):
        server = Server(bundle, params, max_len=48, cuda_graph=graphed)
        state = server.prefill(ids)
        steps = []
        for _ in range(6):
            server.step(state)
            steps.append((state.logits.clone(),
                          state.cache["experts"].clone()))
        runs.append(steps)
        assert (state.graph is not None) == graphed
    for (a, ea), (b, eb) in zip(*runs):
        assert torch.equal(a, b) and torch.equal(ea, eb)
