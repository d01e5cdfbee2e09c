"""On a card: the latent decode-attention kernel (``csrc/mla_decode.cu``)
against its plain version at the Moonlight cell's shape (16 rows, an 8192
slot latent cache of 576 in bf16, 16 heads) at positions on and next to
the edges of its splits and tiles; a position held on the card against the
same position passed by value, bit for bit; two runs alike, bit for bit; a
captured CUDA graph replayed at new positions against eager launches, bit
for bit; and the model's decode step, whose layers take the kernel 27
times a step at Moonlight's widths and agree with the PyTorch absorbed
path. ``python -m pytest -q -m gpu tests/test_torch_mla_decode_cuda.py``;
skips without a card."""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.mla_decode import kernel as mk
from repro_torch.kernels.mla_decode import plain
from repro_torch.models import mla
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params
from repro_torch.runtime.serve_loop import Server

pytestmark = pytest.mark.gpu

CFG = get_config("moonlight_16b_a3b")
B, T = 16, 8192
SCALE = mla.softmax_scale(CFG)


@pytest.fixture(scope="module")
def operands():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, 1, mk.HEADS, mk.WIDTH), generator=g, device="cuda")
    cache = torch.randn((B, T, mk.WIDTH), generator=g, device="cuda")
    return q.to(torch.bfloat16), cache.to(torch.bfloat16)


def _splits():
    return mk.splits_for(B, T, mk._sm_count(torch.cuda.current_device()))


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# split edges at 8 splits (132 SMs): 512 positions are 8 runs of one tile;
# 513 put one position in a fifth run; 4096 and 8192 fill every run
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 511, 512, 4095, 4104, 6143,
                                 8191, 9000])
@torch.no_grad()
def test_kernel_equals_plain(operands, pos):
    q, cache = operands
    got = mk.mla_decode(q, cache, pos, SCALE)
    want = plain.mla_decode_plain(q, cache, pos, SCALE, _splits())
    torch.cuda.synchronize()
    assert got.shape == (B, 1, mk.HEADS, mk.LAT)
    # the same f32 arithmetic in another order of sums (the tensor cores'
    # within a tile): outputs part by a bf16 rounding here and there, and
    # a probability whose f32 value lies on a bf16 boundary rounds the
    # other way
    assert _rel(got, want) < 4e-3, _rel(got, want)


@torch.no_grad()
def test_kernel_equals_the_absorbed_path(operands):
    q, cache = operands
    got = mk.mla_decode(q, cache, 5000, SCALE)
    want = mla.absorbed(q, cache, 5000, mk.LAT, SCALE)
    assert _rel(got, want) < 4e-3


@pytest.mark.parametrize("pos", [0, 700, 8191])
@torch.no_grad()
def test_a_position_on_the_card_gives_the_same_bits(operands, pos):
    q, cache = operands
    want = mk.mla_decode(q, cache, pos, SCALE)
    got = mk.mla_decode(q, cache, torch.tensor(pos, dtype=torch.int32,
                                               device="cuda"), SCALE)
    again = mk.mla_decode(q, cache, pos, SCALE)
    assert torch.equal(got, want) and torch.equal(again, want)


@torch.no_grad()
def test_graph_replay_equals_eager_launches(operands):
    q, cache = operands
    pos = torch.tensor(100, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mk.mla_decode(q, cache, pos, SCALE)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mk.mla_decode(q, cache, pos, SCALE)
    for at in (100, 4104, 8191, 64):
        pos.fill_(at)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, mk.mla_decode(q, cache, at, SCALE)), at


def test_wrapper_refuses_a_cpu_cache(operands):
    q, cache = operands
    with pytest.raises(ValueError, match="one CUDA device"):
        mk.mla_decode(q, cache[:, :64].cpu(), 3, SCALE)


@torch.no_grad()
def test_a_step_launches_the_kernel_once_a_layer():
    """Moonlight's attention widths and 27 layers, the rest tiny: an eager
    step through the Server counts ``launch._mla_decode`` 27 times, its
    prefill none; a layer's decode attention on the kernel agrees with the
    PyTorch absorbed path's on the cache the steps filled (whole steps
    part: random routing near ties sends a row to other experts on the
    least rounding, PERF.md section 2)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    small = CFG.reduced()
    cfg = dataclasses.replace(
        small, n_layers=27, dtype="bfloat16", kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_heads=16, n_kv_heads=16, head_dim=128, d_model=256)
    bundle = build(cfg, device="cuda")
    params = cast_params(bundle.init(torch.Generator(device="cuda")
                                     .manual_seed(2)), torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 70), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
    count = (lambda: tracing.counters().get("launch._mla_decode", 0))
    server = Server(bundle, params, max_len=80)
    before = count()
    state = server.prefill(ids)
    assert count() == before
    for i in range(3):
        server.step(state)
        assert count() == before + 27 * (i + 1)
    attn = params["layers"]["attn"]
    lp = {name: w[5] for name, w in attn.items()}
    x = torch.randn((4, 1, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)
                    ).bfloat16()
    pos = torch.tensor(73, dtype=torch.int32, device="cuda")
    layer = state.cache["latent"][6]
    got = mla.attention_decode(x, lp, cfg, layer.clone(), pos)
    real = mla._decode_kernel_applies
    mla._decode_kernel_applies = lambda q, cache: False
    try:
        want = mla.attention_decode(x, lp, cfg, layer.clone(), pos)
    finally:
        mla._decode_kernel_applies = real
    # the same bf16 arithmetic but for the probabilities' rounding against
    # a tile's running max and the order of f32 sums
    assert _rel(got, want) < 1e-2, _rel(got, want)
