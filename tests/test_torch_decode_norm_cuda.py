"""On a card: the decode-step norm kernel (``csrc/decode_norm.cu``) against
its plain version at the decode cells' shapes and at widths that leave
lanes idle or hold four chunks a lane: the sum bit for bit, the norm within
one bf16 step (the f32 sum of squares in another order); a captured CUDA
graph replayed on new rows against eager launches, bit for bit; and an
eager step of each MoE family at the cells' depths, which counts
``launch._decode_norm`` 49 times (Qwen1.5-MoE's 24 layers) and 55
(Moonlight's 27) and ``launch._decode_rope`` 24 and 27, and a prefill none.
``python -m pytest -q -m gpu tests/test_torch_decode_norm_cuda.py``; skips
without a card."""

import dataclasses

import pytest
import torch
from _torch_decode_helpers import bf16_steps

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.decode_norm import kernel as nk
from repro_torch.kernels.decode_norm import plain
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

pytestmark = pytest.mark.gpu

EPS = 1e-6


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def operands(rows, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, 1, d), generator=g, device="cuda") * 3
    y = torch.randn((rows, 1, d), generator=g, device="cuda")
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    return x.bfloat16(), y.bfloat16(), scale.bfloat16()


@pytest.mark.parametrize("rows, d", [(4, 2048), (16, 2048), (16, 512),
                                     (3, 520), (2, 8192)],
                         ids=["qwen", "moonlight", "latent_row", "idle_lanes",
                              "four_chunks_a_lane"])
@pytest.mark.parametrize("branch", [True, False], ids=["add", "no_add"])
@torch.no_grad()
def test_kernel_equals_plain(rows, d, branch):
    x, y, scale = operands(rows, d, seed=rows + d)
    y = y if branch else None
    s, got = nk.decode_norm(x, y, scale, EPS)
    want_s, want = plain.decode_norm_plain(x, y, scale, EPS)
    assert torch.equal(s, want_s)
    assert (s is x) == (not branch)
    steps = bf16_steps(got, want)
    assert int(steps.max()) <= 1
    # most outputs are the same bits: the sums part in their last f32 bits
    assert float((steps == 0).float().mean()) > 0.95


@torch.no_grad()
def test_graph_replay_equals_eager_launches():
    x, y, scale = operands(4, 2048, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nk.decode_norm(x, y, scale, EPS)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s, out = nk.decode_norm(x, y, scale, EPS)
    for seed in (2, 3):
        nx, ny, _ = operands(4, 2048, seed)
        x.copy_(nx)
        y.copy_(ny)
        graph.replay()
        torch.cuda.synchronize()
        want_s, want = nk.decode_norm(x, y, scale, EPS)
        assert torch.equal(s, want_s) and torch.equal(out, want)


def test_wrapper_refuses_a_cpu_branch():
    x, y, scale = operands(4, 64, seed=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        nk.decode_norm(x, y.cpu(), scale, EPS)


def _cell_depth(arch):
    """The family's small config at its cell's depth, in bf16: Qwen1.5-MoE's
    24 layers (16 experts top-4), Moonlight's 27 (its dense layer first)."""
    base = get_config(arch).reduced()
    if arch == "qwen1_5_moe_a2_7b":
        return dataclasses.replace(base, n_layers=24, n_experts=16, top_k=4,
                                   dtype="bfloat16")
    return dataclasses.replace(base, n_layers=27, dtype="bfloat16")


@pytest.mark.parametrize("arch, norms, ropes",
                         [("qwen1_5_moe_a2_7b", 49, 24),
                          ("moonlight_16b_a3b", 55, 27)],
                         ids=["qwen", "moonlight"])
@torch.no_grad()
def test_a_step_counts_its_launches_and_a_prefill_none(arch, norms, ropes):
    cfg = _cell_depth(arch)
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(2)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 12), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))

    def counts():
        c = tracing.counters()
        return c.get("launch._decode_norm", 0), c.get("launch._decode_rope", 0)

    server = Server(bundle, params, max_len=20)
    before = counts()
    state = server.prefill(ids)
    assert counts() == before
    for i in range(1, 3):
        server.step(state)
        assert counts() == (before[0] + norms * i, before[1] + ropes * i)
