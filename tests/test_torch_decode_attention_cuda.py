"""On a card: the decode-attention kernel (``csrc/decode_attention.cu``)
against the JAX package's ``_sdpa`` (its outputs stored by
``_decode_attention_cases.py``, since the card runs no JAX) and
against its plain version, at the decode cell's shape (Qwen1.5-MoE-A2.7B's
4 x 8192 x 16 x 128 bf16 cache) and at MobileLLM-125M's grouped one (9
query heads over 3 of 64); captured in a CUDA graph whose position
advances between replays, equal bit for bit to eager launches; and a
decode step on a cache the kernel cannot read raising, not changing path.
``python -m pytest -q -m gpu tests/test_torch_decode_attention_cuda.py``;
skips without a card."""

import dataclasses

import pytest
import torch
from _decode_attention_cases import (CASES, bf16_bound, golden, operands,
                                     rounding_case)

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import plain
from repro_torch.models import layers as L

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _operands(b, t, hq, hkv, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = 3.0 * torch.randn(b, 1, hq, d, generator=g, device=device)
    k = torch.randn(b, t, hkv, d, generator=g, device=device)
    v = torch.randn(b, t, hkv, d, generator=g, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _against_plain(q, k, v, pos, window=-1):
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    splits = dk.splits_for(b, hkv, t, hq // hkv, dk._sm_count(0))
    got = dk.decode_attention(q, k, v, pos, window)
    want = plain.decode_attention_plain(q, k, v, pos, window, splits)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    vmax = v.float().abs().max()
    if q.dtype == torch.float32:
        # the same arithmetic in another order of f32 sums
        bound = 1e-5 * vmax + 1e-5 * want.float().abs()
    else:
        # one bf16 ulp of the output where the f32 sums' order moves it
        # across a rounding boundary, and a probability whose bf16 rounding
        # flips the same way (2**-8 of its share of the output)
        bound = 2**-8 * want.float().abs() + 2**-10 * vmax
    assert (err <= bound).all(), float(err.max())


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_the_jax_sdpa(cuda, case):
    """The operands made here are the CPU's bit for bit; the kernel, at a
    position passed by value and held on the card, lies within the split
    arithmetic's bound of the JAX package's outputs."""
    q, k, v = operands(case, cuda)
    for made_here, made_there in zip((q, k, v), operands(case)):
        assert torch.equal(made_here.cpu(), made_there)
    want = golden(case)
    window, positions = CASES[case][5], CASES[case][6]
    vc = v.cpu()
    for i, pos in enumerate(positions):
        bound = bf16_bound(want[i], vc)
        for where in (pos, torch.tensor(pos, dtype=torch.int32,
                                        device=cuda)):
            got = dk.decode_attention(q, k, v, where, window).cpu()
            err = (got.float() - want[i].float()).abs()
            assert (err <= bound).all(), (pos, float(err.max()))


@pytest.mark.parametrize("pos", [4096, 4103, 6143, 8191])
def test_kernel_equals_plain_at_the_cells_shape(cuda, pos):
    q, k, v = _operands(4, 8192, 16, 16, 128, torch.bfloat16, cuda, seed=pos)
    kernels.reset_launch_counts()
    _against_plain(q, k, v, pos)
    _against_plain(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                         device=cuda))
    assert kernels.launch_counts()["_decode_attention"] == 2


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("window", [-1, 512], ids=["full", "window"])
def test_kernel_equals_plain_at_mobilellms_grouped_shape(cuda, batch, dtype,
                                                        window):
    q, k, v = _operands(batch, 2048, 9, 3, 64, dtype, cuda, seed=batch)
    for pos in (0, 1000, 2047):
        _against_plain(q, k, v, pos, window)


@pytest.mark.parametrize("d", [16, 256])
def test_kernel_equals_plain_at_the_other_head_dims(cuda, d):
    q, k, v = _operands(2, 1024, 8, 2, d, torch.bfloat16, cuda, seed=d)
    for pos in (5, 700):
        _against_plain(q, k, v, pos)


def test_kernel_rounds_the_probabilities_as_sdpa(cuda):
    q, k, v = rounding_case(cuda)
    got = dk.decode_attention(q, k, v, 1)
    assert (got.cpu() == 0.498046875).all()


def test_captured_kernel_equals_eager_launches(cuda):
    """One capture, the position advanced between replays: each replay
    equals an eager launch at the same position, bit for bit."""
    q, k, v = _operands(4, 8192, 16, 16, 128, torch.bfloat16, cuda, seed=9)
    pos = torch.tensor(4096, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.decode_attention(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attention(q, k, v, pos)
    for p in (4096, 4097, 5000, 6143, 8191, 4100):
        pos.fill_(p)
        graph.replay()
        want = dk.decode_attention(q, k, v, p)
        torch.cuda.synchronize()
        assert torch.equal(out, want), p


def test_a_cache_the_kernel_cannot_read_raises(cuda):
    """A strided cache passes the gate in ``_attention_decode`` (one query,
    CUDA, dtypes, head dim and grouping the kernel takes), so the wrapper
    refuses it: the step raises instead of falling back to ``_sdpa``."""
    cfg = dataclasses.replace(get_config("mobilellm_125m").reduced(),
                              head_dim=64)
    g = torch.Generator().manual_seed(0)
    p = {n: w.to(cuda) for n, w in L.init_attention(cfg, g).items()}
    x = torch.randn(2, 1, cfg.d_model, generator=g).to(cuda)
    kc, vc = (torch.zeros(2, cfg.n_kv_heads, 32, 64, device=cuda)
              .transpose(1, 2) for _ in range(2))
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        L.attention_decode(x, p, cfg, kc, vc, 20)
