"""On a card: the decode-step MoE kernel (``csrc/moe_decode.cu``) against its
plain version at the decode cell's widths (one Qwen1.5-MoE-A2.7B layer in
bf16, 4 rows) under even routing, under all rows on the same 4 experts and
under 16 distinct ones, and at 1 and 16 rows; experts no row chose poisoned
with NaN leave the output unchanged; the routing launch's choices are
``moe.top_k``'s on its own logits, ties included; two runs give the same
bits; a Server's eager decode step calls the kernel once a layer, its
prefill never; the softmax routing's outputs are the stored ones
(``_moe_decode_golden.py``), bit for bit; and at Moonlight-16B-A3B's widths,
for 1, 4 and 16 rows, the sigmoid routing with its correction bias and two
ungated shared experts equals plain's. ``python -m pytest -q -m gpu
tests/test_torch_moe_decode_cuda.py``; skips without a card."""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.moe_decode import kernel as mk
from repro_torch.kernels.moe_decode import plain
from repro_torch.models import moe
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

pytestmark = pytest.mark.gpu

CFG = get_config("qwen1_5_moe_a2_7b")


@pytest.fixture(scope="module")
def layer():
    """One layer at the published widths, bf16, normal of spread 0.02."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(11)
    d, e, f = CFG.d_model, CFG.n_experts, CFG.moe_d_ff

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02
                ).to(torch.bfloat16)
    return {"router": normal(d, e),
            "experts": {"w_gate": normal(e, d, f), "w_up": normal(e, d, f),
                        "w_down": normal(e, f, d)},
            "shared": {"w_gate": normal(d, 4 * f), "w_up": normal(d, 4 * f),
                       "w_down": normal(4 * f, d)},
            "shared_gate": normal(d, 1)}


def _args(lp, cfg=CFG):
    return (lp["router"], lp["experts"], lp["shared"], lp["shared_gate"],
            cfg.top_k, cfg.norm_topk_prob)


def _steered(lp, routing: str, n: int, seed: int):
    """Rows and a router under which row r's top experts are fixed: the
    rows carry a direction u_r that the chosen experts' router columns
    read. "skewed": every row on experts 7, 19, 33 and 52; "distinct": row r
    on experts 4r..4r+3; "even": random rows, the router as drawn."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = CFG.d_model
    x = torch.randn((n, d), generator=g, device="cuda")
    if routing == "even":
        return x.to(torch.bfloat16), lp
    u = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device="cuda"), dim=1)
    router = lp["router"].float().clone()
    if routing == "skewed":
        u = u[:1].expand(n, d)
        for e in (7, 19, 33, 52):
            router[:, e] += 0.5 * u[0]
    else:
        for r in range(n):
            router[:, 4 * r:4 * r + 4] += 0.5 * u[r][:, None]
    x = 0.5 * x + 4.0 * u
    return x.to(torch.bfloat16), dict(lp, router=router.to(torch.bfloat16))


def _against_plain(x, lp):
    got, routing = mk.moe_decode(x, *_args(lp))
    want, wrouting = plain.moe_decode_plain(x, *_args(lp))
    torch.cuda.synchronize()
    assert torch.equal(routing.sel, wrouting.sel)
    assert torch.equal(routing.counts, wrouting.counts)
    # the same f32 arithmetic in another order of sums: the outputs differ
    # by a bf16 rounding where a sum crosses a rounding boundary
    err = float((got.float() - want.float()).norm() / want.float().norm())
    assert err < 1e-3, err
    return got, routing


@pytest.mark.parametrize("routing, n", [("even", 4), ("skewed", 4),
                                        ("distinct", 4), ("even", 1),
                                        ("even", 16)])
@torch.no_grad()
def test_kernel_equals_plain(layer, routing, n):
    x, lp = _steered(layer, routing, n, seed=20 + n)
    _, r = _against_plain(x, lp)
    chosen = int((r.counts > 0).sum())
    if routing == "skewed":
        assert sorted(torch.unique(r.sel).tolist()) == [7, 19, 33, 52]
    if routing == "distinct":
        assert chosen == 16


@torch.no_grad()
def test_unchosen_experts_are_never_read(layer):
    """Experts no row chose, their weights NaN: the output is unchanged,
    bit for bit; a chosen one NaN spreads."""
    x, _ = _steered(layer, "even", 4, seed=31)
    want, r = mk.moe_decode(x, *_args(layer))
    chosen = set(torch.unique(r.sel).tolist())
    poisoned = dict(layer, experts={k: w.clone() for k, w in
                                    layer["experts"].items()})
    unchosen = [e for e in range(CFG.n_experts) if e not in chosen]
    for w in poisoned["experts"].values():
        w[unchosen] = float("nan")
    got, _ = mk.moe_decode(x, *_args(poisoned))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    for w in poisoned["experts"].values():
        w[min(chosen)] = float("nan")
    bad, _ = mk.moe_decode(x, *_args(poisoned))
    assert torch.isnan(bad).any()


@pytest.mark.parametrize("norm", [False, True])
@torch.no_grad()
def test_routing_is_top_k_on_its_logits_ties_included(layer, norm):
    """Router columns 7 and 11, and 19, 40 and 41, equal and favoured: their
    logits tie exactly, and the kernel's choices and weights are
    ``moe.top_k``'s on the logits it computed, the lower index first."""
    cfg = dataclasses.replace(CFG, norm_topk_prob=norm)
    x, lp = _steered(layer, "skewed", 16, seed=41)
    router = lp["router"].clone()
    router[:, 11] = router[:, 7]
    router[:, 41] = router[:, 40] = router[:, 19]
    lp = dict(lp, router=router)
    _, r = mk.moe_decode(x, *_args(lp, cfg))
    sel, gates = moe.top_k(r.logits, cfg)
    torch.cuda.synchronize()
    assert torch.equal(r.logits[:, 7], r.logits[:, 11])
    assert torch.equal(r.sel.long(), sel)
    torch.testing.assert_close(r.gates, gates, rtol=1e-6, atol=1e-7)
    for lo, hi in ((7, 11), (19, 40), (40, 41)):
        # the higher of a tied pair never without the lower, and after it
        has_lo, has_hi = (r.sel == lo).any(1), (r.sel == hi).any(1)
        assert not (has_hi & ~has_lo).any()
        both = has_lo & has_hi
        assert ((r.sel == lo).int().argmax(1)[both]
                < (r.sel == hi).int().argmax(1)[both]).all()
    _, wr = plain.moe_decode_plain(x, *_args(lp, cfg))
    assert torch.equal(r.sel, wr.sel)


@torch.no_grad()
def test_two_runs_give_the_same_bits(layer):
    x, _ = _steered(layer, "even", 4, seed=51)
    first, r1 = mk.moe_decode(x, *_args(layer))
    second, r2 = mk.moe_decode(x, *_args(layer))
    assert torch.equal(first, second)
    assert torch.equal(r1.logits, r2.logits)
    assert torch.equal(r1.gates, r2.gates)


@torch.no_grad()
def test_a_step_calls_the_kernel_once_a_layer():
    """24 layers at the tiny widths: an eager decode step through the
    Server counts ``launch._moe_decode`` 24 times, its prefill none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = dataclasses.replace(CFG.reduced(), n_layers=24, n_experts=16,
                              top_k=4, dtype="bfloat16")
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(2)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 12), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
    server = Server(bundle, params, max_len=20)
    count = (lambda: tracing.counters().get("launch._moe_decode", 0))
    before = count()
    state = server.prefill(ids)
    assert count() == before
    for i in range(3):
        server.step(state)
        assert count() == before + 24 * (i + 1)


@torch.no_grad()
def test_softmax_routing_is_unchanged_bit_for_bit():
    """Qwen1.5-MoE-A2.7B's routing and outputs on the kernel path, for 1, 4
    and 16 rows, are the stored ones (``tests/_moe_decode_golden.py``,
    written by the kernel before its sigmoid mode), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import numpy as np

    import _moe_decode_golden as golden

    want = np.load(golden.GOLDEN)
    got = golden.outputs(mk.moe_decode)
    assert sorted(got) == sorted(want.files)
    for name, value in got.items():
        assert np.array_equal(value, want[name]), name


def _moonlight_layer(seed: int):
    """One MoE layer at Moonlight-16B-A3B's widths, bf16: 64 experts of
    1408, two shared experts (2816), a correction bias of spread 0.05."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, e, f = 2048, 64, 1408

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).to(torch.bfloat16)
    return {"router": normal(d, e),
            "experts": {"w_gate": normal(e, d, f), "w_up": normal(e, d, f),
                        "w_down": normal(e, f, d)},
            "shared": {"w_gate": normal(d, 2 * f), "w_up": normal(d, 2 * f),
                       "w_down": normal(2 * f, d)},
            "router_bias": normal(e, std=0.05)}


@pytest.mark.parametrize("n", [1, 4, 16])
@torch.no_grad()
def test_sigmoid_routing_at_moonlight_widths_equals_plain(n):
    """DeepSeek-V3's routing (sigmoid scores, the choice on score + bias,
    the unbiased scores renormalised and times 2.446) with two ungated
    shared experts: the kernel's choices are ``moe.top_k``'s on its own
    logits, its weights theirs, and its output plain's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = get_config("moonlight_16b_a3b")
    lp = _moonlight_layer(60 + n)
    x = torch.randn((n, 2048), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(70 + n)).to(torch.bfloat16)
    kw = dict(scoring="sigmoid", bias=lp["router_bias"],
              scale=cfg.routed_scaling_factor)
    args = (lp["router"], lp["experts"], lp["shared"], None, cfg.top_k, True)
    got, r = mk.moe_decode(x, *args, **kw)
    want, wr = plain.moe_decode_plain(x, *args, **kw)
    sel, gates = moe.top_k(r.logits, cfg, lp["router_bias"])
    torch.cuda.synchronize()
    assert torch.equal(r.sel.long(), sel)
    torch.testing.assert_close(r.gates, gates, rtol=1e-6, atol=1e-6)
    assert torch.equal(r.sel, wr.sel) and torch.equal(r.counts, wr.counts)
    torch.testing.assert_close(r.logits, wr.logits, rtol=1e-4, atol=1e-4)
    assert (r.gates.sum(1) - cfg.routed_scaling_factor).abs().max() < 1e-5
    err = float((got.float() - want.float()).norm() / want.float().norm())
    assert err < 1e-3, err
