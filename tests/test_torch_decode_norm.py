"""The decode-step norm kernel's CPU side (``kernels/decode_norm``): its plain
version against ``models/layers.py``'s residual add and ``rms_norm``, bit
for bit, at the decode cells' widths (Qwen1.5-MoE's 4 rows and Moonlight's
16 of 2048, Moonlight's latent row of 512); the mean's factor; the
wrapper's refusals; the gate, which sends the CPU, a kept gradient, a
DTensor, prefill-sized rows, f32 and other widths to the eager ops; and a
CPU decode step of both MoE families, which gives the bits of the loop
that took each add and norm as two ops. The kernel itself runs only on a
card (``tests/test_torch_decode_norm_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_decode_helpers import OnCard

from repro_torch.configs import get_config
from repro_torch.kernels.decode_norm import kernel as nk
from repro_torch.kernels.decode_norm import plain
from repro_torch.models import layers as L
from repro_torch.models import mla, moe
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import cast_params

torch.set_num_threads(1)

EPS = 1e-6


def operands(rows, d, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, 1, d), generator=g) * 3
    y = torch.randn((rows, 1, d), generator=g)
    scale = 1 + 0.1 * torch.randn((d,), generator=g)
    return x.to(dtype), y.to(dtype), scale.to(dtype)


@pytest.mark.parametrize("rows, d", [(4, 2048), (16, 2048), (16, 512)],
                         ids=["qwen", "moonlight", "latent_row"])
@pytest.mark.parametrize("branch", [True, False], ids=["add", "no_add"])
def test_plain_equals_the_eager_add_and_norm(rows, d, branch):
    x, y, scale = operands(rows, d)
    y = y if branch else None
    s, out = plain.decode_norm_plain(x, y, scale, EPS)
    want_s = x + y if branch else x
    assert torch.equal(s, want_s)
    assert torch.equal(out, L.rms_norm(want_s, scale, EPS))
    assert torch.equal(L.add_rms_norm(x, y, scale, EPS)[1], out)


def test_the_mean_factor_is_one_over_the_width():
    assert nk.mean_factor(4, 2048) == 2.0 ** -11
    assert nk.mean_factor(16, 512) == 2.0 ** -9
    assert nk.mean_factor(3, 1000) == float(np.float32(3) / np.float32(3000))


def _bad(**changes):
    x, y, scale = operands(2, 64)
    args = {"x": x, "y": y, "scale": scale, **changes}
    return args


@pytest.mark.parametrize("args, says", [
    (_bad(), "CUDA device"),
    (_bad(x=torch.zeros(2, 1, 64)), "dtypes"),
    (_bad(scale=torch.ones(64)), "dtypes"),
    (_bad(x=torch.zeros(2, 1, 60, dtype=torch.bfloat16),
          y=torch.zeros(2, 1, 60, dtype=torch.bfloat16),
          scale=torch.ones(60, dtype=torch.bfloat16)), "width"),
    (_bad(x=torch.zeros(1, 1, 8200, dtype=torch.bfloat16), y=None,
          scale=torch.ones(8200, dtype=torch.bfloat16)), "width"),
    (_bad(y=torch.zeros(2, 2, 64, dtype=torch.bfloat16)), "shapes"),
    (_bad(scale=torch.ones(32, dtype=torch.bfloat16)), "shapes"),
    (_bad(x=torch.zeros(2, 1, 128, dtype=torch.bfloat16)[..., ::2]),
     "contiguous"),
    (_bad(x=torch.zeros(129, dtype=torch.bfloat16)[1:].view(2, 1, 64)),
     "16 bytes"),
], ids=["cpu", "f32", "f32_scale", "width_60", "width_8200", "branch_shape",
        "scale_shape", "strided", "unaligned"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(args, says):
    """Each refusal for its own reason; the device, checked last, refuses
    every CPU tensor."""
    with pytest.raises(ValueError, match=says):
        nk.decode_norm(args["x"], args["y"], args["scale"], EPS)


@pytest.mark.parametrize("case", ["applies", "no_branch", "cpu", "dtensor",
                                  "grad", "prefill", "f32", "f32_scale",
                                  "width"])
def test_gate_takes_the_kernel_only_where_it_applies(case, monkeypatch):
    s, d = (2 if case == "prefill" else 1), (60 if case == "width" else 64)
    x = torch.zeros(2, s, d, dtype=torch.bfloat16,
                    requires_grad=case == "grad")
    y = None if case == "no_branch" else torch.zeros_like(x)
    scale = torch.ones(d, dtype=torch.float32 if case == "f32_scale"
                       else torch.bfloat16)
    if case == "f32":
        x, y = x.float(), y.float()
    if case != "cpu":
        x, scale = OnCard(x), OnCard(scale)
        y = None if y is None else OnCard(y)
    if case == "dtensor":
        monkeypatch.setattr(L, "_is_dtensor", lambda t: True)
    assert L._norm_kernel_applies(x, y, scale) == (
        case in ("applies", "no_branch"))
    if case == "grad":
        with torch.no_grad():
            assert L._norm_kernel_applies(x, y, scale)


def _parent_decode_step(params, cache, tokens, pos, cfg):
    """``moe.decode_step`` as it was before its adds joined its norms: each
    residual add and each norm an op of its own."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    records = cache.get("experts")
    k = cfg.first_k_dense_replace
    for i, (lp, dense) in enumerate(moe.layer_stack(params, cfg)):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla:
            attn_out = mla.attention_decode(h, lp["attn"], cfg,
                                            cache["latent"][i], pos)
        else:
            attn_out, _, _ = L.attention_decode(
                h, lp["attn"], cfg, cache["k"][i], cache["v"][i], pos,
                cfg.window_for_layer(i))
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        record = None if dense or records is None else records[i - k]
        x = x + moe._ffn(h, lp, cfg, dense, record)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)[:, 0], cache


@pytest.mark.parametrize("arch", ["qwen1_5_moe_a2_7b", "moonlight_16b_a3b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_decode_step_is_the_parents(arch, dtype, monkeypatch):
    """On the CPU the norm kernel's wrapper is never called, and a decode
    step's logits, cache and experts are the parent's loop's, bit for
    bit, over three steps from a prefill."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype="bfloat16" if dtype == torch.bfloat16
                              else "float32")

    def refuse(*a):
        raise AssertionError("the norm kernel's wrapper ran on the CPU")

    monkeypatch.setattr(L.norm_kernel, "decode_norm", refuse)
    bundle = build(cfg, device="cpu")
    params = cast_params(bundle.init(torch.Generator().manual_seed(7)), dtype)
    ids = torch.randint(0, cfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(8))
    _, cache = moe.prefill(params, ids, cfg, 10)
    twin = {name: t.clone() for name, t in cache.items()}
    tok = ids[:, -1:]
    for pos in (6, 7, torch.tensor(8, dtype=torch.int32)):
        got, cache = moe.decode_step(params, cache, tok, pos, cfg)
        want, twin = _parent_decode_step(params, twin, tok, pos, cfg)
        assert torch.equal(got, want)
        for name in cache:
            assert torch.equal(cache[name], twin[name]), name
        tok = torch.argmax(got, dim=-1, keepdim=True).to(torch.int32)
