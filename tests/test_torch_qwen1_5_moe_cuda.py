"""On a card: the dropless expert layer of Qwen1.5-MoE-A2.7B at its
published widths in bf16 on its grouped path (``torch._grouped_mm`` on the
card's grouped kernels, which a decode step's few rows leave for
``kernels/moe_decode``) never reads an expert that no token chose, and at a
prefill's size equals each expert run on its own rows in float32 within
bf16's rounding; and the ``Server``'s decode step captured as a CUDA graph,
its MoE layers on ``kernels/moe_decode``, gives the eager step's tokens and
logits, across a restart of the position.
``python -m pytest -q -m gpu tests/test_torch_qwen1_5_moe_cuda.py``;
skips without a card."""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

pytestmark = pytest.mark.gpu

CFG = get_config("qwen1_5_moe_a2_7b")


@pytest.fixture(scope="module")
def layer():
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


def rows(n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((4, n, CFG.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


@pytest.fixture
def grouped(monkeypatch):
    """The grouped path, whatever the rows: the decode kernel's gate
    shut."""
    monkeypatch.setattr(moe, "_decode_kernel_applies", lambda *a: False)


@torch.no_grad()
def test_unchosen_experts_are_never_read(layer, grouped):
    x = rows(1, 3)
    sel, _ = moe.top_k((x @ layer["router"]).float(), CFG)
    chosen = sorted(set(sel.reshape(-1).tolist()))
    assert len(chosen) < CFG.n_experts
    want = moe.moe_ffn(x, layer, CFG)
    poisoned = dict(layer, experts={n: w.clone() for n, w in
                                    layer["experts"].items()})
    unchosen = [e for e in range(CFG.n_experts) if e not in chosen]
    for w in poisoned["experts"].values():
        w[unchosen] = float("nan")
    assert torch.equal(moe.moe_ffn(x, poisoned, CFG), want)


@torch.no_grad()
def test_grouped_layer_equals_each_expert_alone(layer, grouped):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = rows(512, 5)
    got = moe.moe_ffn(x, layer, CFG).float()
    t = x.reshape(-1, CFG.d_model).float()
    probs = torch.softmax(t @ layer["router"].float(), dim=-1)
    weight, chosen = torch.topk(probs, CFG.top_k, dim=-1)
    want = torch.zeros_like(t)
    ex = {n: w.float() for n, w in layer["experts"].items()}
    for e in range(CFG.n_experts):
        tok, slot = torch.where(chosen == e)
        h = t[tok]
        act = torch.nn.functional.silu(h @ ex["w_gate"][e]) \
            * (h @ ex["w_up"][e])
        want.index_add_(0, tok, (act @ ex["w_down"][e])
                        * weight[tok, slot, None])
    sh = {n: w.float() for n, w in layer["shared"].items()}
    shared = (torch.nn.functional.silu(t @ sh["w_gate"]) * (t @ sh["w_up"])
              ) @ sh["w_down"]
    want = want + torch.sigmoid(t @ layer["shared_gate"].float()) * shared
    err = (got.reshape(-1, CFG.d_model) - want).norm() / want.norm()
    # bf16 activations between the projections and bf16 outputs: a few
    # bf16 roundings (2**-8 each) of the layer's output
    assert err < 2e-2, float(err)


@torch.no_grad()
def test_captured_step_equals_the_eager_step():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # bf16, as served: the grouped matmuls' f32 form reads its group
    # offsets on the host, which a capture refuses
    cfg = dataclasses.replace(CFG.reduced(), n_experts=16, top_k=4,
                              dtype="bfloat16")
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(2)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 12), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
    runs = []
    launches = tracing.counters().get("launch._moe_decode", 0)
    for graph in (False, True):
        server = Server(bundle, params, max_len=20, cuda_graph=graph)
        state = server.prefill(ids)
        steps = []
        for i in range(12):
            if state.pos == 20:  # restart after the prompt, as a loop may
                state.pos = 12
            steps.append((server.step(state).copy(), state.logits.clone()))
        assert (state.graph is not None) == graph
        runs.append(steps)
    for (want_tok, want), (got_tok, got) in zip(*runs):
        assert (got_tok == want_tok).all()
        assert torch.equal(got, want)
    # the eager steps and the capture ran the decode kernel, a layer each
    assert tracing.counters().get("launch._moe_decode", 0) - launches \
        >= 13 * cfg.n_layers
