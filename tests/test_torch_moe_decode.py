"""The decode-step MoE kernel's CPU side (``kernels/moe_decode``): its plain
version against ``models/moe.py``'s grouped path (``_dropless_experts`` and
the gated shared expert) on the tiny MoE config and on one layer at
Qwen1.5-MoE-A2.7B's published widths, for 1, 4 and 16 rows; its routing
against ``moe.top_k``, ties included; the wrapper's refusals; the gate, which
sends prefill-sized rows, a kept gradient, the capacity path, DTensors and
the CPU to the old path; and ``moe_ffn``'s use of the kernel where the gate
opens. The kernel itself runs only on a card
(``tests/test_torch_moe_decode_cuda.py``)."""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.moe_decode import kernel as mk
from repro_torch.kernels.moe_decode import plain
from repro_torch.models import layers as L
from repro_torch.models import moe

torch.set_num_threads(1)

PUBLISHED = get_config("qwen1_5_moe_a2_7b")


def tiny(**changes):
    """The published config at the tiny size: width 64, 16 experts of 32,
    top-4, one shared expert of 32."""
    cfg = dataclasses.replace(PUBLISHED.reduced(), n_experts=16, top_k=4)
    return dataclasses.replace(cfg, **changes)


def layer_of(cfg, dtype, seed=0) -> dict:
    """One MoE layer's weights of ``cfg`` in ``dtype``, normal of spread
    0.02 (the config's initializer range) but the router's, 0.5, so that
    the bf16 router logits seldom tie."""
    g = torch.Generator().manual_seed(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    fs = cfg.n_shared_experts * f

    def normal(*shape, std=0.02):
        return torch.empty(shape, dtype=dtype).normal_(0, std, generator=g)
    return {"router": normal(d, e, std=0.5),
            "experts": {"w_gate": normal(e, d, f), "w_up": normal(e, d, f),
                        "w_down": normal(e, f, d)},
            "shared": {"w_gate": normal(d, fs), "w_up": normal(d, fs),
                       "w_down": normal(fs, d)},
            "shared_gate": normal(d, 1, std=0.5)}


def rows(n, d, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g).to(dtype)


def run_plain(x2, lp, cfg):
    return plain.moe_decode_plain(
        x2, lp["router"], lp["experts"],
        lp["shared"] if cfg.n_shared_experts else None,
        lp["shared_gate"] if cfg.shared_expert_gate else None,
        cfg.top_k, cfg.norm_topk_prob)


@pytest.fixture(scope="module")
def published_layer():
    return layer_of(PUBLISHED, torch.bfloat16)


CASES = [("tiny", torch.float32, {}), ("tiny", torch.bfloat16, {}),
         ("tiny", torch.float32, {"norm_topk_prob": True}),
         ("tiny", torch.float32, {"shared_expert_gate": False}),
         ("published", torch.bfloat16, {})]


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("case", CASES, ids=["tiny_f32", "tiny_bf16",
                                             "tiny_f32_renormalised",
                                             "tiny_f32_ungated",
                                             "published_bf16"])
@torch.no_grad()
def test_plain_equals_the_grouped_path(case, n, request):
    """Same routing as ``moe.top_k`` on the grouped path's logits; outputs
    equal in f32 up to the order of f32 sums, and in bf16 up to the grouped
    path's roundings between the projections (a few bf16 ulps of the
    output)."""
    name, dtype, changes = case
    if name == "tiny":
        cfg = tiny(**changes)
        lp = layer_of(cfg, dtype)
    else:
        cfg = PUBLISHED
        lp = request.getfixturevalue("published_layer")
    x = rows(n, cfg.d_model, dtype).reshape(n, 1, cfg.d_model)
    want = moe.moe_ffn(x, lp, cfg).reshape(n, cfg.d_model).float()
    got, routing = run_plain(x.reshape(n, -1), lp, cfg)
    sel, gates = moe.top_k((x @ lp["router"]).float(), cfg)
    assert torch.equal(routing.sel.long(), sel.reshape(n, -1))
    torch.testing.assert_close(routing.gates, gates.reshape(n, -1),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(routing.counts,
                       torch.bincount(sel.reshape(-1),
                                      minlength=cfg.n_experts).int())
    err = float((got.float() - want).norm() / want.norm())
    assert err < (1e-6 if dtype == torch.float32 else 1e-2), err


@pytest.mark.parametrize("norm", [False, True])
def test_routing_ties_go_to_the_lower_expert(norm):
    """Router columns 3 and 7, and 5 and 6, equal: their logits tie exactly,
    and the plain routing picks as ``moe.top_k`` does, the lower first."""
    cfg = tiny(norm_topk_prob=norm)
    lp = layer_of(cfg, torch.bfloat16, seed=4)
    lp["router"][:, [3, 5]] *= 4  # chosen by most rows
    lp["router"][:, 7] = lp["router"][:, 3]
    lp["router"][:, 6] = lp["router"][:, 5]
    x = rows(16, cfg.d_model, torch.bfloat16, seed=6)
    routing = plain.route(x, lp["router"], lp["shared_gate"], cfg.top_k,
                          norm)
    sel, gates = moe.top_k(routing.logits, cfg)
    assert torch.equal(routing.sel.long(), sel)
    torch.testing.assert_close(routing.gates, gates, rtol=0, atol=0)
    tied = (routing.logits[:, 3] == routing.logits[:, 7])
    assert tied.all()
    pos = {e: (routing.sel == e).int().argmax(dim=1) for e in (3, 7)}
    both = (routing.sel == 3).any(1) & (routing.sel == 7).any(1)
    assert both.any()
    assert (pos[3][both] < pos[7][both]).all()


def _operands(n=4, **bad):
    """Valid operands of the tiny config in bf16 on the CPU, with ``bad``
    laid over them: (x, router, experts, shared, shared_gate, top_k)."""
    cfg = tiny()
    lp = layer_of(cfg, torch.bfloat16)
    args = {"x": rows(n, cfg.d_model, torch.bfloat16),
            "router": lp["router"], "experts": lp["experts"],
            "shared": lp["shared"], "shared_gate": lp["shared_gate"],
            "top_k": cfg.top_k}
    for key, value in bad.items():
        if key in ("w_gate", "w_up", "w_down"):
            args["experts"] = dict(args["experts"], **{key: value})
        elif key.startswith("s_"):
            args["shared"] = dict(args["shared"], **{key[2:]: value})
        else:
            args[key] = value
    return args


D, E, F = 64, 16, 32
BF = dict(dtype=torch.bfloat16)


@pytest.mark.parametrize("bad, says", [
    ({}, "CUDA device"),
    ({"x": torch.zeros(4, 1, D, **BF)}, "bad shapes"),
    ({"x": torch.zeros(17, D, **BF)}, "17 rows"),
    ({"x": torch.zeros(4, D)}, "dtypes"),
    ({"router": torch.zeros(D, E)}, "dtypes"),
    ({"router": torch.zeros(D + 8, E, **BF)}, "bad shapes"),
    ({"router": torch.zeros(D, 65, **BF)}, "bad expert shapes"),
    ({"w_gate": torch.zeros(E, D, F)}, "dtypes"),
    ({"w_up": torch.zeros(E, D, F + 8, **BF)}, "bad expert shapes"),
    ({"w_down": torch.zeros(E, D, F, **BF)}, "bad expert shapes"),
    ({"w_down": torch.zeros(E, D, F, **BF).transpose(1, 2)}, "contiguous"),
    ({"s_w_gate": torch.zeros(D, 48, **BF)}, "shared expert shapes"),
    ({"s_w_down": torch.zeros(F, D)}, "dtypes"),
    ({"shared_gate": torch.zeros(D, 2, **BF)}, "gate shape"),
    ({"x": torch.zeros(4 * D + 1, **BF)[1:].view(4, D)}, "16 bytes"),
    ({"top_k": 9}, "not the kernel's"),
], ids=["cpu", "x_3d", "rows", "x_f32", "router_f32", "router_rows",
        "experts_65", "w_gate_f32", "w_up_shape", "w_down_shape",
        "w_down_strided", "shared_width", "shared_f32", "gate_shape",
        "unaligned_x", "top_k"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, says):
    """Each refusal for its own reason; the device, checked last, refuses
    every CPU tensor."""
    args = _operands(**bad)
    with pytest.raises(ValueError, match=says):
        mk.moe_decode(**args, norm_topk_prob=False)


def test_widths_the_kernel_takes():
    assert mk.takes(2048, 1408, 60, 4)
    assert not mk.takes(2048, 1404, 60, 4)
    assert not mk.takes(2052, 1408, 60, 4)
    assert not mk.takes(16384, 1408, 60, 4)
    assert not mk.takes(2048, 1408, 65, 4)
    assert not mk.takes(2048, 1408, 60, 9)


class _OnCard:
    """A CPU tensor that reports a card: what the gate reads of a CUDA
    operand."""

    def __init__(self, t):
        self.t = t

    @property
    def device(self):
        return torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self.t, name)


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    return fn(node)


@pytest.mark.parametrize("case", ["applies", "applies_16", "prefill", "cpu",
                                  "grad", "capacity", "dtensor", "f32",
                                  "f32_router", "experts_65"])
def test_gate_takes_the_kernel_only_where_it_applies(case, monkeypatch):
    """Open for a decode step's few bf16 rows on a card; shut for a
    prefill's rows, the CPU, a kept gradient, the capacity path, DTensors,
    another dtype and widths the kernel does not take."""
    cfg = tiny(moe_dropless=case != "capacity",
               n_experts=65 if case == "experts_65" else 16)
    lp = layer_of(cfg, torch.float32 if case == "f32" else torch.bfloat16)
    if case == "f32_router":
        lp["router"] = lp["router"].float()
    n = {"prefill": 17, "applies_16": 16}.get(case, 4)
    x = rows(n, cfg.d_model, lp["router"].dtype if case == "f32"
             else torch.bfloat16).reshape(n // 4 if n % 4 == 0 else 1,
                                          -1, cfg.d_model)
    if case == "grad":
        lp["experts"]["w_up"].requires_grad_(True)
    if case != "cpu":
        x, lp = _OnCard(x), _tree_map(_OnCard, lp)
    if case == "dtensor":
        monkeypatch.setattr(L, "_is_dtensor", lambda y: True)
    assert moe._decode_kernel_applies(x, lp, cfg) == case.startswith(
        "applies")
    if case == "grad":
        with torch.no_grad():
            assert moe._decode_kernel_applies(x, lp, cfg)


@torch.no_grad()
def test_moe_ffn_takes_the_kernel_where_the_gate_opens(monkeypatch):
    """With the gate forced open, ``moe_ffn`` returns the wrapper's rows
    and counts the experts its routing read while recording, none dropped;
    the wrapper, standing in for the card, is the plain version."""
    cfg = tiny()
    lp = layer_of(cfg, torch.bfloat16)
    x = rows(4, cfg.d_model, torch.bfloat16).reshape(2, 2, cfg.d_model)
    monkeypatch.setattr(moe, "_decode_kernel_applies", lambda *a: True)
    monkeypatch.setattr(moe.decode_kernel, "moe_decode",
                        plain.moe_decode_plain)
    want, routing = run_plain(x.reshape(4, -1), lp, cfg)
    tracing.reset_counters("moe.")
    tracing.enable()
    try:
        got = moe.moe_ffn(x, lp, cfg)
    finally:
        tracing.disable()
        spans = {s.name for s in tracing.collect()}
    counts = tracing.counters()
    assert torch.equal(got, want.reshape(2, 2, -1))
    assert "moe.ffn" in spans and "moe.experts" not in spans
    assert counts["moe.experts_read"] == int((routing.counts > 0).sum())
    assert counts["moe.dropped"] == 0
    assert counts["moe.assignments"] == 4 * cfg.top_k


@torch.no_grad()
def test_cpu_layer_never_calls_the_wrapper(monkeypatch):
    """On the CPU the gate stays shut: ``moe_ffn`` is the grouped path bit
    for bit, and ``launch._moe_decode`` does not move."""
    cfg = tiny()
    lp = layer_of(cfg, torch.bfloat16)
    x = rows(4, cfg.d_model, torch.bfloat16).reshape(4, 1, cfg.d_model)

    def refuse(*a):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(moe.decode_kernel, "moe_decode", refuse)
    before = tracing.counters().get("launch._moe_decode", 0)
    got = moe.moe_ffn(x, lp, cfg)
    want = moe._dropless_experts(x, lp, cfg) + torch.sigmoid(
        x @ lp["shared_gate"]) * L.mlp(x, lp["shared"], "silu")
    assert torch.equal(got, want)
    assert tracing.counters().get("launch._moe_decode", 0) == before


MOONLIGHT = get_config("moonlight_16b_a3b")


def sigmoid_layer(cfg, dtype, seed=0) -> dict:
    """One DeepSeek-V3 MoE layer of ``cfg`` in ``dtype``: the router of
    spread 0.02, a correction bias of spread 0.05, two shared experts."""
    lp = layer_of(cfg, dtype, seed)
    g = torch.Generator().manual_seed(seed + 1)
    lp.pop("shared_gate")
    lp["router"] = torch.empty_like(lp["router"]).normal_(0, 0.02,
                                                          generator=g)
    lp["router_bias"] = torch.empty((cfg.n_experts,), dtype=dtype).normal_(
        0, 0.05, generator=g)
    return lp


@pytest.fixture(scope="module")
def moonlight_layer():
    return sigmoid_layer(MOONLIGHT, torch.bfloat16)


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("case", ["tiny_f32", "tiny_bf16", "published_bf16"])
@torch.no_grad()
def test_plain_sigmoid_routing_equals_the_grouped_path(case, n, request):
    """DeepSeek-V3's routing on both: the choice on sigmoid scores plus the
    bias, the unbiased scores renormalised and times 2.446, two ungated
    shared experts; the same routing as ``moe.top_k`` on the f32 logits,
    the outputs as in :func:`test_plain_equals_the_grouped_path`."""
    if case == "published_bf16":
        cfg, dtype = MOONLIGHT, torch.bfloat16
        lp = request.getfixturevalue("moonlight_layer")
    else:
        dtype = torch.float32 if case == "tiny_f32" else torch.bfloat16
        cfg = dataclasses.replace(MOONLIGHT.reduced(), n_experts=16, top_k=6)
        lp = sigmoid_layer(cfg, dtype)
    x = rows(n, cfg.d_model, dtype).reshape(n, 1, cfg.d_model)
    want = moe.moe_ffn(x, lp, cfg).reshape(n, cfg.d_model).float()
    got, routing = plain.moe_decode_plain(
        x.reshape(n, -1), lp["router"], lp["experts"], lp["shared"], None,
        cfg.top_k, cfg.norm_topk_prob, scoring="sigmoid",
        bias=lp["router_bias"], scale=cfg.routed_scaling_factor)
    sel, gates = moe.top_k(moe.router_logits(x, lp["router"], cfg), cfg,
                           lp["router_bias"])
    assert torch.equal(routing.sel.long(), sel.reshape(n, -1))
    torch.testing.assert_close(routing.gates, gates.reshape(n, -1),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(routing.gates.sum(-1), torch.full(
        (n,), cfg.routed_scaling_factor), rtol=1e-6, atol=1e-6)
    assert torch.equal(routing.shared_gate, torch.ones(n))
    err = float((got.float() - want).norm() / want.norm())
    assert err < (1e-6 if dtype == torch.float32 else 1e-2), err


@torch.no_grad()
def test_the_bias_chooses_and_the_scores_weigh():
    """A bias that lifts expert 5 far above the rest puts it first in every
    row, yet weighs it by its unbiased score; without the bias, the choice
    is the scores' own top-k."""
    cfg = dataclasses.replace(MOONLIGHT.reduced(), n_experts=16, top_k=6)
    lp = sigmoid_layer(cfg, torch.float32)
    x = rows(4, cfg.d_model, torch.float32)
    bias = torch.zeros(cfg.n_experts)
    bias[5] = 10.0
    kw = dict(scoring="sigmoid", scale=cfg.routed_scaling_factor)
    r = plain.route(x, lp["router"], None, cfg.top_k, True, bias=bias, **kw)
    scores = torch.sigmoid(x @ lp["router"])
    assert (r.sel[:, 0] == 5).all()
    norm = torch.gather(scores, 1, r.sel.long()).sum(-1)
    torch.testing.assert_close(r.gates[:, 0], scores[:, 5] / norm
                               * cfg.routed_scaling_factor)
    free = plain.route(x, lp["router"], None, cfg.top_k, True, **kw)
    assert torch.equal(free.sel.long(),
                       torch.topk(scores, cfg.top_k, dim=-1)[1])
    assert torch.equal(free.logits, x @ lp["router"])


def test_wrapper_refuses_a_bad_bias_or_record():
    cfg = dataclasses.replace(MOONLIGHT.reduced(), n_experts=16, top_k=6)
    lp = sigmoid_layer(cfg, torch.bfloat16)
    x = rows(2, cfg.d_model, torch.bfloat16)
    args = (x, lp["router"], lp["experts"], lp["shared"], None, 6, True)
    with pytest.raises(ValueError, match="bias shape"):
        mk.moe_decode(*args, scoring="sigmoid", bias=lp["router_bias"][:8])
    with pytest.raises(ValueError, match="scoring"):
        mk.moe_decode(*args, scoring="softplus")
    with pytest.raises(ValueError, match="sel must be"):
        mk.moe_decode(*args, scoring="sigmoid", bias=lp["router_bias"],
                      sel=torch.zeros((2, 5), dtype=torch.int32))
