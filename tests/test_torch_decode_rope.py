"""The decode-step attention prologue kernel's CPU side
(``kernels/decode_rope``): its plain version against the eager path bit for
bit, in both modes:

- GQA at Qwen1.5-MoE-A2.7B's widths (4 rows, 16 heads of 128, q/k/v
  biases, RoPE theta 1e6) against ``layers._qkv`` + ``apply_rope`` and
  the cache write ``layers.attention_decode`` makes, a position passed by
  value and held in a tensor;
- MLA at Moonlight-16B-A3B's widths (16 rows, 16 heads of 128 + 64, a
  latent row of 512 + 64, theta 5e4) against ``mla.project``,
  ``mla.write_row`` and the query ``mla.attention_decode`` builds;

at positions 0, 4104, T - 1 and beyond T (the slot clamped, the angle
not); the frequencies against the float64 formula the kernel computes; the
wrappers' refusals; and the gates, which send the CPU, a kept gradient, a
DTensor, prefill-sized rows, f32, mrope and other widths to the eager ops,
and a ring or sliced cache past the kernel. The kernel itself runs only on
a card (``tests/test_torch_decode_rope_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_decode_helpers import OnCard

from repro_torch.configs import get_config
from repro_torch.kernels.decode_rope import kernel as rk
from repro_torch.kernels.decode_rope import plain
from repro_torch.models import layers as L
from repro_torch.models import mla

torch.set_num_threads(1)

QWEN = get_config("qwen1_5_moe_a2_7b")
MOONLIGHT = get_config("moonlight_16b_a3b")
T = 4112          # slots of the tests' caches: 4104 inside, 4200 beyond
POSITIONS = [0, 4104, T - 1, 4200]
D_MODEL = 256     # x's width: the prologue starts from the projections


def _normal(g, *shape, std=1.0):
    return (torch.randn(shape, generator=g) * std).to(torch.bfloat16)


@pytest.fixture(scope="module")
def qwen():
    """A Qwen layer's attention at its published head widths on a narrow
    x, in bf16, and the layer's rows."""
    cfg = dataclasses.replace(QWEN, d_model=D_MODEL)
    g = torch.Generator().manual_seed(1)
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    p = {"wq": _normal(g, D_MODEL, q_dim, std=0.1),
         "wk": _normal(g, D_MODEL, kv_dim, std=0.1),
         "wv": _normal(g, D_MODEL, kv_dim, std=0.1),
         "wo": _normal(g, q_dim, D_MODEL, std=0.05),
         "bq": _normal(g, q_dim, std=0.5), "bk": _normal(g, kv_dim, std=0.5),
         "bv": _normal(g, kv_dim, std=0.5)}
    return cfg, p, _normal(g, 4, 1, D_MODEL)


def _position(pos, as_tensor):
    return torch.tensor(pos, dtype=torch.int32) if as_tensor else pos


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("pos", POSITIONS)
@torch.no_grad()
def test_gqa_plain_equals_the_eager_prologue(qwen, pos, as_tensor):
    cfg, p, x = qwen
    shape = (4, T, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = torch.zeros(shape, dtype=torch.bfloat16), \
        torch.zeros(shape, dtype=torch.bfloat16)
    kp, vp = kc.clone(), vc.clone()
    at = _position(pos, as_tensor)
    L.attention_decode(x, p, cfg, kc, vc, at)
    q, k, v = (x @ p[w] for w in ("wq", "wk", "wv"))
    got = plain.decode_rope_plain(q, k, v, kp, vp, at, cfg.rope_theta,
                                  (p["bq"], p["bk"], p["bv"]))
    qe, _, _ = L._qkv(x, p, cfg)
    want = L.apply_rope(qe, torch.full((4, 1), pos, dtype=torch.int32),
                        cfg.rope_theta)
    assert torch.equal(got, want)
    assert torch.equal(kp, kc) and torch.equal(vp, vc)
    slot = min(pos, T - 1)
    assert kc[:, slot].abs().sum() > 0 and vc[:, slot].abs().sum() > 0


@torch.no_grad()
def test_gqa_plain_without_biases_at_a_group_of_four():
    cfg = dataclasses.replace(QWEN.reduced(), n_heads=8, n_kv_heads=2,
                              head_dim=64, qkv_bias=False)
    g = torch.Generator().manual_seed(2)
    p = {"wq": _normal(g, cfg.d_model, cfg.q_dim, std=0.1),
         "wk": _normal(g, cfg.d_model, cfg.kv_dim, std=0.1),
         "wv": _normal(g, cfg.d_model, cfg.kv_dim, std=0.1),
         "wo": _normal(g, cfg.q_dim, cfg.d_model, std=0.1)}
    x = _normal(g, 3, 1, cfg.d_model)
    kc = torch.zeros((3, 40, 2, 64), dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    kp, vp = kc.clone(), vc.clone()
    L.attention_decode(x, p, cfg, kc, vc, 17)
    q, k, v = (x @ p[w] for w in ("wq", "wk", "wv"))
    got = plain.decode_rope_plain(q, k, v, kp, vp, 17, cfg.rope_theta)
    want = L.apply_rope(L._qkv(x, p, cfg)[0],
                        torch.full((3, 1), 17, dtype=torch.int32),
                        cfg.rope_theta)
    assert torch.equal(got, want)
    assert torch.equal(kp, kc) and torch.equal(vp, vc)


@pytest.fixture(scope="module")
def moonlight():
    """A Moonlight layer's latent attention at its published widths on a
    narrow x, in bf16, and the layer's rows."""
    cfg = dataclasses.replace(MOONLIGHT, d_model=D_MODEL)
    g = torch.Generator().manual_seed(3)
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    p = {"wq": _normal(g, D_MODEL, h * (nope + rope), std=0.1),
         "wkv_a": _normal(g, D_MODEL, r + rope, std=0.1),
         "kv_norm": (1 + 0.1 * torch.randn(r, generator=g)).bfloat16(),
         "wkv_b": _normal(g, r, h * (nope + cfg.v_head_dim), std=0.05)}
    return cfg, p, _normal(g, 16, 1, D_MODEL)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("pos", POSITIONS)
@torch.no_grad()
def test_mla_plain_equals_project_and_write_row(moonlight, pos, as_tensor):
    cfg, p, x = moonlight
    b, nope = x.shape[0], cfg.qk_nope_head_dim
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    cache = torch.zeros((b, T, width), dtype=torch.bfloat16)
    mine = cache.clone()
    at = _position(pos, as_tensor)
    q_nope, q_pe, latent = mla.project(
        x, p, cfg, torch.full((b, 1), pos, dtype=torch.int32))
    mla.write_row(cache, latent, at)
    w_uk, _ = mla._heads_of(p["wkv_b"], cfg)
    q_lat = mla._absorb(q_nope, w_uk)
    want = torch.cat([q_lat, q_pe[:, 0]], dim=-1)[:, None]
    q = x @ p["wq"]
    got = plain.decode_rope_mla_plain(
        q, x @ p["wkv_a"], p["kv_norm"],
        mla._absorb(q.view(b, 1, cfg.n_heads, -1)[..., :nope], w_uk), mine,
        at, cfg.rope_theta, nope, mla.KV_NORM_EPS)
    assert torch.equal(got, want)
    assert torch.equal(mine, cache)
    assert cache[:, min(pos, T - 1)].abs().sum() > 0


@pytest.mark.parametrize("d, theta", [(128, 1e6), (64, 5e4), (16, 1e4)])
def test_frequencies_are_the_eager_ones_and_the_kernels(d, theta):
    """The eager path's f32 frequencies, and the float64 formula each lane
    of the kernel computes, ``f32(1 / theta^(2i / d))``."""
    got = plain.freqs(d, theta, "cpu")
    assert torch.equal(got, L._rope_freqs_on(d, theta, torch.device("cpu")))
    lane = np.array([np.float32(1.0 / np.power(theta, (2.0 * i) / d))
                     for i in range(d // 2)], np.float32)
    assert np.array_equal(got.numpy(), lane)


def _gqa_args(**changes):
    bf = dict(dtype=torch.bfloat16)
    args = {"q": torch.zeros(2, 1, 4 * 64, **bf),
            "k": torch.zeros(2, 1, 2 * 64, **bf),
            "v": torch.zeros(2, 1, 2 * 64, **bf),
            "kc": torch.zeros(2, 16, 2, 64, **bf),
            "vc": torch.zeros(2, 16, 2, 64, **bf), "pos": 3, "bias": None}
    args.update(changes)
    return args


@pytest.mark.parametrize("args, says", [
    (_gqa_args(), "CUDA device"),
    (_gqa_args(q=torch.zeros(2, 1, 256)), "dtypes"),
    (_gqa_args(kc=torch.zeros(2, 16, 2, 63, dtype=torch.bfloat16),
               vc=torch.zeros(2, 16, 2, 63, dtype=torch.bfloat16)),
     "head dim"),
    (_gqa_args(vc=torch.zeros(2, 15, 2, 64, dtype=torch.bfloat16)),
     "shapes"),
    (_gqa_args(q=torch.zeros(2, 1, 3 * 64, dtype=torch.bfloat16)),
     "projection shapes"),
    (_gqa_args(k=torch.zeros(2, 2, 2 * 64, dtype=torch.bfloat16)),
     "projection shapes"),
    (_gqa_args(bias=tuple(torch.zeros(n, dtype=torch.bfloat16)
                          for n in (256, 128, 64))), "bias shapes"),
    (_gqa_args(kc=torch.zeros(2, 16, 64, 2, dtype=torch.bfloat16)
               .transpose(2, 3)), "unit stride"),
    (_gqa_args(pos=-1), "out of range"),
    (_gqa_args(pos=torch.tensor(3)), "0-dim int32"),
], ids=["cpu", "f32", "odd_head_dim", "cache_shapes", "query_heads",
        "two_positions", "bias_shapes", "strided_dim", "negative_pos",
        "pos_int64"])
def test_gqa_wrapper_raises_on_what_the_kernel_does_not_take(args, says):
    with pytest.raises(ValueError, match=says):
        rk.decode_rope(args["q"], args["k"], args["v"], args["kc"],
                       args["vc"], args["pos"], 1e4, args["bias"])


def _mla_args(**changes):
    bf = dict(dtype=torch.bfloat16)
    args = {"q": torch.zeros(2, 1, 4 * (16 + 8), **bf),
            "kv": torch.zeros(2, 1, 32 + 8, **bf),
            "norm": torch.ones(32, **bf), "q_lat": torch.zeros(2, 4, 32, **bf),
            "cache": torch.zeros(2, 16, 32 + 8, **bf), "pos": 3}
    args.update(changes)
    return args


@pytest.mark.parametrize("args, says", [
    (_mla_args(), "CUDA device"),
    (_mla_args(norm=torch.ones(32)), "dtypes"),
    (_mla_args(q_lat=torch.zeros(2, 4, 1100, dtype=torch.bfloat16),
               norm=torch.ones(1100, dtype=torch.bfloat16)), "latent rows"),
    (_mla_args(cache=torch.zeros(2, 16, 32 + 7, dtype=torch.bfloat16)),
     "latent rows"),
    (_mla_args(kv=torch.zeros(2, 1, 32, dtype=torch.bfloat16)), "shapes"),
    (_mla_args(q=torch.zeros(2, 1, 4 * 24 + 1, dtype=torch.bfloat16)),
     "shapes"),
    (_mla_args(pos=torch.tensor([3], dtype=torch.int32)), "0-dim int32"),
], ids=["cpu", "f32_norm", "wide_latent", "odd_rope", "kv_shape", "q_shape",
        "pos_not_0d"])
def test_mla_wrapper_raises_on_what_the_kernel_does_not_take(args, says):
    with pytest.raises(ValueError, match=says):
        rk.decode_rope_mla(args["q"], args["kv"], args["norm"],
                           args["q_lat"], args["cache"], args["pos"], 1e4,
                           16, 1e-6)


GATE_CASES = ["applies", "cpu", "dtensor", "grad", "prefill", "f32",
              "f32_cache", "width"]


@pytest.mark.parametrize("case", GATE_CASES + ["mrope", "no_bias"])
def test_gqa_gate_takes_the_kernel_only_where_it_applies(case, monkeypatch):
    cfg = dataclasses.replace(
        QWEN.reduced(), n_heads=4, n_kv_heads=2,
        head_dim=15 if case == "width" else 16, qkv_bias=case != "no_bias",
        mrope_sections=(4, 2, 2) if case == "mrope" else ())
    g = torch.Generator().manual_seed(0)
    p = L.init_attention(cfg, g)
    p = {n: w.to(torch.float32 if case == "f32" else torch.bfloat16)
         .requires_grad_(case == "grad") for n, w in p.items()}
    x = torch.zeros(2, 2 if case == "prefill" else 1, cfg.d_model,
                    dtype=torch.float32 if case == "f32" else torch.bfloat16)
    kc = torch.zeros(2, 8, 2, cfg.head_dim, dtype=torch.float32
                     if case == "f32_cache" else torch.bfloat16)
    vc = torch.zeros_like(kc)
    if case != "cpu":
        x, kc, vc = OnCard(x), OnCard(kc), OnCard(vc)
    if case == "dtensor":
        monkeypatch.setattr(L, "_is_dtensor", lambda t: True)
    assert L._prologue_kernel_applies(x, p, cfg, kc, vc) == (
        case in ("applies", "no_bias"))
    if case == "grad":
        with torch.no_grad():
            assert L._prologue_kernel_applies(x, p, cfg, kc, vc)


@pytest.mark.parametrize("route", ["plain_cache", "ring", "sliced"])
def test_ring_and_sliced_caches_keep_the_eager_prologue(route, monkeypatch):
    """With the gate forced open, only a cache neither ring nor sliced to a
    static window reaches the kernel's wrapper."""
    cfg = dataclasses.replace(get_config("mobilellm_125m").reduced(),
                              head_dim=64)
    g = torch.Generator().manual_seed(4)
    p = L.init_attention(cfg, g)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    kc = torch.zeros(2, 32, cfg.n_kv_heads, 64)
    vc = torch.zeros_like(kc)
    calls = []

    def fake(q, k, v, k_cache, v_cache, pos, theta, bias=None):
        calls.append(pos)
        return plain.decode_rope_plain(q, k, v, k_cache, v_cache, pos, theta,
                                       bias)

    monkeypatch.setattr(L, "_prologue_kernel_applies", lambda *a: True)
    monkeypatch.setattr(L.rope_kernel, "decode_rope", fake)
    monkeypatch.setattr(L, "DECODE_WINDOW_SLICING", route == "sliced")
    with torch.no_grad():
        L.attention_decode(x, p, cfg, kc, vc, 20, window=8, static_window=8,
                           ring=route == "ring")
    assert calls == ([20] if route == "plain_cache" else [])


@pytest.mark.parametrize("case", GATE_CASES)
def test_mla_gate_takes_the_kernel_only_where_it_applies(case, monkeypatch):
    cfg = MOONLIGHT.reduced()
    if case == "width":
        cfg = dataclasses.replace(cfg, qk_rope_head_dim=7)
    g = torch.Generator().manual_seed(0)
    p = mla.init_attention(cfg, g)
    p = {n: w.to(torch.float32 if case == "f32" else torch.bfloat16)
         .requires_grad_(case == "grad") for n, w in p.items()}
    x = torch.zeros(2, 2 if case == "prefill" else 1, cfg.d_model,
                    dtype=torch.float32 if case == "f32" else torch.bfloat16)
    cache = torch.zeros(2, 8, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                        dtype=torch.float32 if case == "f32_cache"
                        else torch.bfloat16)
    if case != "cpu":
        x, cache = OnCard(x), OnCard(cache)
    if case == "dtensor":
        monkeypatch.setattr(L, "_is_dtensor", lambda t: True)
    assert mla._prologue_kernel_applies(x, p, cfg, cache) == (
        case == "applies")
    if case == "grad":
        with torch.no_grad():
            assert mla._prologue_kernel_applies(x, p, cfg, cache)


@pytest.mark.parametrize("arch", ["mobilellm_125m", "qwen1_5_moe_a2_7b"])
def test_cpu_attention_decode_never_calls_the_wrapper(arch, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the prologue kernel's wrapper ran on the CPU")

    monkeypatch.setattr(L.rope_kernel, "decode_rope", refuse)
    monkeypatch.setattr(mla.rope_kernel, "decode_rope_mla", refuse)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    g = torch.Generator().manual_seed(5)
    p = {n: w.bfloat16() for n, w in L.init_attention(cfg, g).items()}
    x = torch.randn(2, 1, cfg.d_model, generator=g).bfloat16()
    kc = torch.zeros(2, 16, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.bfloat16)
    with torch.no_grad():
        L.attention_decode(x, p, cfg, kc, kc.clone(), 5)
    cfg = dataclasses.replace(MOONLIGHT.reduced(), dtype="bfloat16")
    p = {n: w.bfloat16() for n, w in mla.init_attention(cfg, g).items()}
    cache = torch.zeros(2, 16, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                        dtype=torch.bfloat16)
    with torch.no_grad():
        mla.attention_decode(torch.randn(2, 1, cfg.d_model, generator=g)
                             .bfloat16(), p, cfg, cache, 5)
