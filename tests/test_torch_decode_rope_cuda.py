"""On a card: the decode-step attention prologue kernel
(``csrc/decode_rope.cu``) in both modes against its plain version and the
eager path:

- GQA at the Qwen1.5-MoE cell's shape (4 rows, 16 heads of 128, q/k/v
  biases, an 8192-slot bf16 cache) at positions 0, 4104, T - 1 and beyond
  T, passed by value and held on the card: q and both caches bit for bit;
  a group of four without biases on a cache laid out (B, H, T, D), written
  through its strides;
- MLA at the Moonlight cell's shape (16 rows, 16 heads of 128 + 64, a
  latent row of 512 + 64): the query and the rows' k_pe bit for bit, c_kv
  within one bf16 step (kv_norm's f32 sum in another order);
- a captured CUDA graph replayed at new positions against eager launches,
  bit for bit, in both modes;
- a layer's decode attention with the gate open against the same layer
  with it shut: GQA bit for bit, MLA within the latent row's bf16 step;
- a dense-family config's decode steps through the Server (the prologue
  kernel in each layer, its norms eager) equal to the same steps with the
  gate shut, bit for bit.

``python -m pytest -q -m gpu tests/test_torch_decode_rope_cuda.py``; skips
without a card."""

import dataclasses

import pytest
import torch
from _torch_decode_helpers import bf16_steps

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.decode_rope import kernel as rk
from repro_torch.kernels.decode_rope import plain
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

pytestmark = pytest.mark.gpu

QWEN = get_config("qwen1_5_moe_a2_7b")
MOONLIGHT = get_config("moonlight_16b_a3b")
T = 8192
POSITIONS = [0, 4104, T - 1, 9000]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def normal(g, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()


def on_card(pos, held):
    return torch.tensor(pos, dtype=torch.int32, device="cuda") if held \
        else pos


@pytest.fixture(scope="module")
def gqa():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    b, h, d = 4, QWEN.n_heads, QWEN.head_dim
    proj = tuple(normal(g, b, 1, h * d) for _ in range(3))
    bias = tuple(normal(g, h * d, std=0.5) for _ in range(3))
    caches = normal(g, b, T, h, d), normal(g, b, T, h, d)
    return proj, bias, caches


@pytest.mark.parametrize("held", [False, True], ids=["int", "on_card"])
@pytest.mark.parametrize("pos", POSITIONS)
@torch.no_grad()
def test_gqa_kernel_equals_plain(gqa, pos, held):
    (q, k, v), bias, (kc, vc) = gqa
    kc, vc = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    got = rk.decode_rope(q, k, v, kc, vc, on_card(pos, held),
                         QWEN.rope_theta, bias)
    want = plain.decode_rope_plain(q, k, v, kp, vp, pos, QWEN.rope_theta,
                                   bias)
    assert torch.equal(got, want)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@torch.no_grad()
def test_gqa_group_of_four_on_a_strided_cache():
    g = torch.Generator(device="cuda").manual_seed(2)
    b, hq, hkv, d, t = 3, 8, 2, 64, 100
    q, k, v = normal(g, b, 1, hq * d), normal(g, b, 1, hkv * d), \
        normal(g, b, 1, hkv * d)
    kc = normal(g, b, hkv, t, d).transpose(1, 2)
    vc = normal(g, b, hkv, t, d).transpose(1, 2)
    kp, vp = kc.clone(), vc.clone()
    got = rk.decode_rope(q, k, v, kc, vc, 57, 1e4)
    want = plain.decode_rope_plain(q, k, v, kp, vp, 57, 1e4)
    assert torch.equal(got, want)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.fixture(scope="module")
def latent():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, r = 16, MOONLIGHT.n_heads, MOONLIGHT.kv_lora_rank
    nope, rope = MOONLIGHT.qk_nope_head_dim, MOONLIGHT.qk_rope_head_dim
    q, kv = normal(g, b, 1, h * (nope + rope)), normal(g, b, 1, r + rope)
    norm = (1 + 0.1 * torch.randn(r, generator=g, device="cuda")).bfloat16()
    q_lat = normal(g, h, b, r).transpose(0, 1)   # as mla._absorb gives it
    return q, kv, norm, q_lat, normal(g, b, T, r + rope)


def _mla(args, cache, pos):
    q, kv, norm, q_lat, _ = args
    return rk.decode_rope_mla(q, kv, norm, q_lat, cache, pos,
                              MOONLIGHT.rope_theta,
                              MOONLIGHT.qk_nope_head_dim, mla.KV_NORM_EPS)


@pytest.mark.parametrize("held", [False, True], ids=["int", "on_card"])
@pytest.mark.parametrize("pos", POSITIONS)
@torch.no_grad()
def test_mla_kernel_equals_plain(latent, pos, held):
    q, kv, norm, q_lat, cache = latent
    r = MOONLIGHT.kv_lora_rank
    cache, mine = cache.clone(), cache.clone()
    got = _mla(latent, cache, on_card(pos, held))
    want = plain.decode_rope_mla_plain(
        q, kv, norm, q_lat, mine, pos, MOONLIGHT.rope_theta,
        MOONLIGHT.qk_nope_head_dim, mla.KV_NORM_EPS)
    assert torch.equal(got, want)
    assert torch.equal(cache[..., r:], mine[..., r:])
    slot = min(pos, T - 1)
    assert int(bf16_steps(cache[:, slot, :r], mine[:, slot, :r]).max()) <= 1
    others = torch.ones(T, dtype=torch.bool, device="cuda")
    others[slot] = False
    assert torch.equal(cache[:, others], mine[:, others])


@torch.no_grad()
def test_graph_replay_equals_eager_launches_in_both_modes(gqa, latent):
    (q, k, v), bias, (kc, vc) = gqa
    lat_cache = latent[4].clone()
    pos = torch.tensor(100, dtype=torch.int32, device="cuda")

    def both(kc, vc, lat_cache, pos):
        return (rk.decode_rope(q, k, v, kc, vc, pos, QWEN.rope_theta, bias),
                _mla(latent, lat_cache, pos))

    kc, vc = kc.clone(), vc.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(kc, vc, lat_cache, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both(kc, vc, lat_cache, pos)
    for at in (100, 4104, 8191, 9000, 64):
        pos.fill_(at)
        graph.replay()
        torch.cuda.synchronize()
        kw, vw, lw = kc.clone(), vc.clone(), lat_cache.clone()
        want = both(kw, vw, lw, at)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), at
        assert torch.equal(kc, kw) and torch.equal(vc, vw)
        assert torch.equal(lat_cache, lw)


@pytest.fixture
def shut(monkeypatch):
    """A call that shuts the prologue gates for what it runs."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(L, "_prologue_kernel_applies", lambda *a: False)
            m.setattr(mla, "_prologue_kernel_applies", lambda *a: False)
            return fn(*args)
    return run


@torch.no_grad()
def test_a_gqa_layer_equals_its_eager_path(shut):
    cfg = dataclasses.replace(QWEN, d_model=256)
    g = torch.Generator(device="cuda").manual_seed(5)
    p = {"wq": normal(g, 256, cfg.q_dim, std=0.1),
         "wk": normal(g, 256, cfg.kv_dim, std=0.1),
         "wv": normal(g, 256, cfg.kv_dim, std=0.1),
         "wo": normal(g, cfg.q_dim, 256, std=0.05),
         "bq": normal(g, cfg.q_dim, std=0.5),
         "bk": normal(g, cfg.kv_dim, std=0.5),
         "bv": normal(g, cfg.kv_dim, std=0.5)}
    x = normal(g, 4, 1, 256)
    kc = normal(g, 4, 4200, cfg.n_kv_heads, cfg.head_dim)
    vc = normal(g, 4, 4200, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.tensor(4104, dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    launches = tracing.counters().get("launch._decode_rope", 0)
    got = L.attention_decode(x, p, cfg, k1, v1, pos)[0]
    assert tracing.counters().get("launch._decode_rope", 0) == launches + 1
    want = shut(L.attention_decode, x, p, cfg, k2, v2, pos)[0]
    assert tracing.counters().get("launch._decode_rope", 0) == launches + 1
    assert torch.equal(got, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@torch.no_grad()
def test_a_latent_layer_is_its_eager_path_within_a_step_of_the_norm(shut):
    cfg = dataclasses.replace(MOONLIGHT, d_model=256)
    g = torch.Generator(device="cuda").manual_seed(6)
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    p = {"wq": normal(g, 256, h * (nope + rope), std=0.1),
         "wkv_a": normal(g, 256, r + rope, std=0.1),
         "kv_norm": (1 + 0.1 * torch.randn(r, generator=g, device="cuda")
                     ).bfloat16(),
         "wkv_b": normal(g, r, h * (nope + cfg.v_head_dim), std=0.05),
         "wo": normal(g, h * cfg.v_head_dim, 256, std=0.05)}
    x = normal(g, 16, 1, 256)
    cache = normal(g, 16, 4200, r + rope)
    pos = torch.tensor(4104, dtype=torch.int32, device="cuda")
    c1, c2 = cache.clone(), cache.clone()
    got = mla.attention_decode(x, p, cfg, c1, pos)
    want = shut(mla.attention_decode, x, p, cfg, c2, pos)
    assert int(bf16_steps(c1, c2).max()) <= 1
    assert torch.equal(c1[..., r:], c2[..., r:])
    err = float((got.float() - want.float()).norm() / want.float().norm())
    # one bf16 step in some of the latent row's 512 dims, through the
    # attention over 4105 rows: a small part of a bf16 rounding
    assert err < 1e-2, err


@torch.no_grad()
def test_dense_family_decode_equals_its_eager_path(shut):
    cfg = dataclasses.replace(get_config("mobilellm_125m").reduced(),
                              dtype="bfloat16")
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(7)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 12), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(8))

    def steps():
        server = Server(bundle, params, max_len=20)
        state = server.prefill(ids)
        out = []
        for _ in range(4):
            server.step(state)
            out.append(state.logits.clone())
        return out

    launches = tracing.counters().get("launch._decode_rope", 0)
    got = steps()
    assert tracing.counters().get("launch._decode_rope", 0) \
        == launches + 4 * cfg.n_layers
    want = shut(steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
