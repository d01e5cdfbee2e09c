"""The decode-attention kernel's plain version (``kernels/decode_attention``)
against ``layers._sdpa`` and the JAX package's ``_sdpa`` at one query a
row, the JAX outputs stored for the card tests, the wrapper's checks, and
the gate in ``layers._attention_decode`` that keeps ``_sdpa`` wherever the
kernel does not apply (every CPU run among them, bit for bit)."""

import dataclasses

import pytest
import torch
from _decode_attention_cases import (CASES, bf16_bound, golden, jax_golden,
                                     jax_sdpa_decode, operands,
                                     rounding_case)

from _torch_decode_helpers import OnCard as _OnCard

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import plain
from repro_torch.models import layers as L

# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

T = 256   # four splits at one row and two KV heads on the H100's 132 SMs
WINDOW = 40
SMS = 132  # an H100's: the kernel's split count on the card


def _operands(b, hq, hkv, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    # q scaled up: peaked scores, so a split's max differs from the row's
    q = (3.0 * torch.randn(b, 1, hq, d, generator=g)).to(dtype)
    k = torch.randn(b, T, hkv, d, generator=g).to(dtype)
    v = torch.randn(b, T, hkv, d, generator=g).to(dtype)
    return q, k, v


def _sdpa_decode(q, k, v, pos, window):
    """``_attention_decode``'s ``_sdpa`` call on a cache neither ring nor
    sliced."""
    rows = torch.full((1,), int(pos), dtype=torch.int32)
    cols = torch.arange(k.shape[1], dtype=torch.int32)
    return L._sdpa(q, k, v, rows=rows, cols=cols, window=window, causal=True)


def test_split_runs_cover_the_visible_positions():
    splits = dk.splits_for(1, 2, T, 1, SMS)
    assert splits == 4
    for pos, window in ((0, -1), (127, -1), (T - 1, -1), (T + 5, -1),
                        (0, WINDOW), (127, WINDOW), (T - 1, WINDOW)):
        runs = plain.split_runs(pos, T, window, splits)
        lo, hi = plain.visible(pos, T, window)
        seen = [i for a, e in runs for i in range(a, e)]
        assert seen == list(range(lo, hi + 1))
        lens = [e - a for a, e in runs if e > a]
        assert all(n == lens[0] and n % plain.ALIGN == 0 for n in lens[:-1])


def _plain(q, k, v, pos, window=-1):
    """The plain version with the kernel's splits on an H100."""
    b, _, hq, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    splits = dk.splits_for(b, hkv, t, hq // hkv, SMS)
    return plain.decode_attention_plain(q, k, v, pos, window, splits)


POSITIONS = pytest.mark.parametrize("pos", [0, 127, T - 1],
                                    ids=["first", "split_boundary", "last"])
WINDOWS = pytest.mark.parametrize("window", [-1, WINDOW],
                                  ids=["full", "window"])
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


@POSITIONS
@WINDOWS
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 2), (8, 2)],
                         ids=["mha", "gqa2", "gqa3", "gqa4"])
@pytest.mark.parametrize("d", [64, 128])
@DTYPES
@pytest.mark.parametrize("on_device", [False, True], ids=["int", "tensor"])
def test_plain_equals_sdpa_at_one_query(pos, window, heads, d, dtype,
                                        on_device):
    hq, hkv = heads
    q, k, v = _operands(1, hq, hkv, d, dtype, seed=pos + d)
    where = torch.tensor(pos, dtype=torch.int32) if on_device else pos
    got = _plain(q, k, v, where, window)
    want = _sdpa_decode(q, k, v, pos, window)
    _assert_split_arithmetic_close(got, want, v, hq, d, dtype)


def _assert_split_arithmetic_close(got, want, v, hq, d, dtype):
    assert got.shape == want.shape == (1, 1, hq * d)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        # f32 throughout: only the order of the sums and the splits'
        # exp(m_split - m) weights differ
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    err = (got.float() - want.float()).abs()
    assert (err <= bf16_bound(want, v)).all(), float(err.max())


@POSITIONS
@WINDOWS
@pytest.mark.parametrize("heads", [(4, 4), (6, 2)], ids=["mha", "gqa3"])
@DTYPES
def test_plain_equals_the_jax_sdpa_at_one_query(pos, window, heads, dtype):
    """The JAX package's ``_sdpa`` as its ``attention_decode`` calls it: the
    same bounds as against the port's (its probabilities are rounded
    against the running max of 1024-key chunks)."""
    hq, hkv = heads
    q, k, v = _operands(1, hq, hkv, 64, dtype, seed=pos + hq)
    got = _plain(q, k, v, pos, window)
    want = jax_sdpa_decode(q, k, v, pos, window)
    _assert_split_arithmetic_close(got, want, v, hq, 64, dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_and_the_stored_outputs_equal_the_jax_sdpa(case):
    """At the decode cell's shape (4 x 8192 x 16 x 128) and MobileLLM's
    grouped one with a window: the outputs stored for the card tests are
    the JAX package's, within one bf16 ulp (XLA may order a product's f32
    sums by its thread count), and the plain version lies within the
    split arithmetic's bound of them."""
    want = jax_golden(case)
    stored = golden(case)
    assert stored.shape == want.shape
    assert ((stored.float() - want.float()).abs()
            <= 2**-7 * want.float().abs()).all()
    q, k, v = operands(case)
    window, positions = CASES[case][5], CASES[case][6]
    for i, pos in enumerate(positions):
        err = (_plain(q, k, v, pos, window).float() - want[i].float()).abs()
        assert (err <= bf16_bound(want[i], v)).all(), (pos, float(err.max()))


def test_probabilities_are_rounded_to_the_cache_dtype():
    q, k, v = rounding_case()
    got = _plain(q, k, v, 1)
    assert torch.equal(got, _sdpa_decode(q, k, v, 1, -1))
    assert torch.equal(got, jax_sdpa_decode(q, k, v, 1, -1))
    assert (got == 0.498046875).all()


def test_plain_splits_are_the_kernels_on_a_position_tensor():
    q, k, v = _operands(2, 6, 2, 64, torch.bfloat16, seed=5)
    a = _plain(q, k, v, 100)
    b = _plain(q, k, v, torch.tensor(100, dtype=torch.int32))
    assert torch.equal(a, b)


def _bad(**change):
    q, k, v = _operands(1, 4, 2, 64, torch.float32)
    args = dict(q=q, k=k, v=v, pos=10, window=-1)
    args.update(change)
    return args


@pytest.mark.parametrize("args,says", [
    (_bad(q=torch.zeros(1, 1, 4, 64, dtype=torch.float16)), "dtypes"),
    (_bad(q=torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)), "dtypes"),
    (_bad(q=torch.zeros(1, 1, 4, 64, device="meta")), "CUDA device"),
    (_bad(), "CUDA device"),
    (_bad(q=torch.zeros(1, 2, 4, 64)), "shapes"),
    (_bad(q=torch.zeros(1, 1, 3, 64)), "query heads"),
    (_bad(q=torch.zeros(1, 1, 4, 32), k=torch.zeros(1, T, 2, 32),
          v=torch.zeros(1, T, 2, 32)), "head dim"),
    (_bad(q=torch.zeros(1, 1, 24, 64)), "query heads"),
    (_bad(v=torch.zeros(1, T - 1, 2, 64)), "shapes"),
    (_bad(k=torch.zeros(1, 2, T, 64).transpose(1, 2)), "contiguous"),
    (_bad(q=torch.zeros(4 * 64 + 1)[1:].view(1, 1, 4, 64)), "16 bytes"),
    (_bad(window=0), "window of 0"),
    (_bad(pos=-1), "sees no slot"),
    (_bad(pos=T + WINDOW, window=WINDOW), "sees no slot"),
    (_bad(pos=torch.tensor(10)), "0-dim int32"),
    (_bad(pos=torch.tensor([10], dtype=torch.int32)), "0-dim int32"),
], ids=["f16", "mixed_dtypes", "device", "cpu", "two_queries", "group",
        "head_dim", "group_over_8", "cache_shapes", "strided_cache",
        "unaligned_q", "window_0", "negative_pos", "pos_past_window",
        "pos_int64", "pos_not_0d"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(args, says):
    """Each refusal for its own reason; the device, checked last, refuses
    every CPU tensor."""
    with pytest.raises(ValueError, match=says):
        dk.decode_attention(args["q"], args["k"], args["v"], args["pos"],
                            args["window"])


@pytest.mark.parametrize("case", ["applies", "cpu", "dtensor", "grad",
                                  "prefill", "dtypes", "f16", "head_dim",
                                  "group_over_8", "window_0",
                                  "strided_cache"])
def test_gate_takes_the_kernel_only_where_it_applies(case, monkeypatch):
    """The gate reads where the kernel applies and what it computes (dtypes,
    head dims, grouping, window); a strided cache passes it, so that the
    wrapper raises on it rather than the step changing path."""
    s, d, window = (2 if case == "prefill" else 1), \
        (32 if case == "head_dim" else 64), (0 if case == "window_0" else -1)
    hq = 24 if case == "group_over_8" else 4
    q = torch.zeros(1, s, hq, d, requires_grad=case == "grad")
    k, v = torch.zeros(1, T, 2, d), torch.zeros(1, T, 2, d)
    if case == "dtypes":
        q = q.to(torch.bfloat16)
    if case == "f16":
        q, k, v = q.half(), k.half(), v.half()
    if case == "strided_cache":
        k = torch.zeros(1, 2, T, d).transpose(1, 2)
    if case != "cpu":
        q, k, v = _OnCard(q), _OnCard(k), _OnCard(v)
    if case == "dtensor":
        monkeypatch.setattr(L, "_is_dtensor", lambda y: True)
    assert L._decode_kernel_applies(q, k, v, window) == (
        case in ("applies", "strided_cache"))
    if case == "grad":
        with torch.no_grad():
            assert L._decode_kernel_applies(q, k, v, window)


def _decode_inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = L.init_attention(cfg, g)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    kc = torch.randn(2, 32, cfg.n_kv_heads, cfg.head_dim, generator=g)
    vc = torch.randn(2, 32, cfg.n_kv_heads, cfg.head_dim, generator=g)
    return p, x, kc, vc


@pytest.mark.parametrize("route", ["plain_cache", "ring", "sliced"])
def test_ring_and_sliced_caches_keep_sdpa(route, monkeypatch):
    """With the gate forced open, only a cache neither ring nor sliced to a
    static window reaches the kernel's wrapper."""
    cfg = dataclasses.replace(get_config("mobilellm_125m").reduced(),
                              head_dim=64)
    p, x, kc, vc = _decode_inputs(cfg)
    calls = []

    def fake(q, k, v, pos, window):
        calls.append(pos)
        return _plain(q, k, v, pos, window)

    monkeypatch.setattr(L, "_decode_kernel_applies", lambda *a: True)
    monkeypatch.setattr(L.decode_kernel, "decode_attention", fake)
    monkeypatch.setattr(L, "DECODE_WINDOW_SLICING", route == "sliced")
    with torch.no_grad():
        L.attention_decode(x, p, cfg, kc, vc, 20, window=8,
                           static_window=8, ring=route == "ring")
    assert calls == ([20] if route == "plain_cache" else [])


def test_cpu_decode_is_sdpa_bit_for_bit(monkeypatch):
    """On the CPU the gate stays shut: ``_attention_decode`` gives exactly
    what ``_sdpa`` over the whole cache gives, and never calls the
    wrapper."""
    cfg = dataclasses.replace(get_config("mobilellm_125m").reduced(),
                              head_dim=64)
    p, x, kc, vc = _decode_inputs(cfg, seed=1)

    def refuse(*a):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(L.decode_kernel, "decode_attention", refuse)
    with torch.no_grad():
        got, k2, v2 = L.attention_decode(x, p, cfg, kc.clone(), vc.clone(),
                                         20)
        q, k, v = L._qkv(x, p, cfg)
        pos = torch.full((2, 1), 20, dtype=torch.int32)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        kc[:, 20:21], vc[:, 20:21] = L.apply_rope(k, pos, cfg.rope_theta), v
        want = _sdpa_decode(q, kc, vc, 20, -1) @ p["wo"]
    assert torch.equal(got, want)
    assert torch.equal(k2, kc) and torch.equal(v2, vc)
