"""Latent attention (MLA, DeepSeek-V2/V3's), as Moonlight-16B-A3B publishes
it: no compressed query (``q_lora_rank`` 0), a compressed key-value row of
``kv_lora_rank`` beside one RoPE key of ``qk_rope_head_dim`` shared by every
head.

For a token x a layer computes:

- ``q = x @ wq``, each head's ``qk_nope_head_dim`` + ``qk_rope_head_dim``
  dims, the latter rotated by RoPE;
- ``x @ wkv_a`` = (c_kv ‖ k_pe): c_kv RMS-normed (``kv_norm``, ε 1e-6 as
  the published ``DeepseekV3RMSNorm`` defaults to), k_pe rotated by RoPE;
  the pair is the token's latent cache row, ``kv_lora_rank +
  qk_rope_head_dim`` wide (576 in bf16: 1152 bytes a token and layer);
- ``c_kv @ wkv_b`` = each head's (k_nope ‖ v), its key (k_nope ‖ k_pe);
- softmax attention at scale 1/sqrt(qk_nope_head_dim + qk_rope_head_dim),
  then ``o @ wo``.

RoPE acts on the rotary dims in the checkpoint's interleaved pair order:
pair i is dims (2i, 2i + 1), rotated by ``position * theta^(-2i / d)`` (the
published code de-interleaves to halves before its rotate-half, which
permutes q_pe and k_pe alike and leaves every score as here).

A prefill (and a training forward) runs the decompressed form: every head's
keys and values from the latent rows, through ``layers._sdpa`` with the
values padded to the key width. A decode step runs the absorbed form: the
query's nope dims taken into the latent space through each head's W_UK
(``mla.absorb``), attention of the 16 heads over the latent rows as cached
(``kernels/mla_decode`` on a card, :func:`absorbed` elsewhere), then each
head's W_UV and ``wo`` (``mla.out``). The two forms are the same arithmetic
up to where the products are rounded. On a card a decode step's kv_norm,
RoPE, latent row write and query (q_lat ‖ q_pe) are one launch of the
attention prologue kernel (``kernels/decode_rope``), after the absorption
of the unrotated q_nope.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_rope import kernel as rope_kernel
from repro_torch.kernels.mla_decode import kernel as decode_kernel
from repro_torch.models import layers as L

# The published kv_a_layernorm is ``DeepseekV3RMSNorm(kv_lora_rank)``, whose
# ε defaults to 1e-6 whatever the config's rms_norm_eps.
KV_NORM_EPS = 1e-6


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   stack: tuple[int, ...] = ()) -> dict:
    if cfg.q_lora_rank:
        raise NotImplementedError("a compressed query (q_lora_rank > 0)")
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    return {
        "wq": L._dense_init((*stack, d, h * (nope + rope)), generator),
        "wkv_a": L._dense_init((*stack, d, r + rope), generator),
        "kv_norm": L.init_norm(r, generator, stack),
        "wkv_b": L._dense_init((*stack, r, h * (nope + cfg.v_head_dim)),
                               generator),
        "wo": L._dense_init((*stack, h * cfg.v_head_dim, d), generator),
    }


def softmax_scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def rope(x, positions, theta: float):
    """x (..., S, H, d) rotated pair by pair, pair i = dims (2i, 2i + 1),
    at ``positions`` (..., S), in f32."""
    d = x.shape[-1]
    freqs = L._rope_freqs_on(d, theta, x.device)            # (d/2,)
    angles = positions[..., None].float() * freqs           # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf = x.float().unflatten(-1, (d // 2, 2))
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


def kv_norm(c_kv, scale):
    return L.rms_norm(c_kv, scale, KV_NORM_EPS)


def project(x, p, cfg: ArchConfig, positions):
    """x (B, S, D) at ``positions`` (B, S) -> (q_nope (B, S, H, nope), q_pe
    (B, S, H, rope) rotated, the latent rows (B, S, kv_lora_rank + rope):
    c_kv normed ‖ k_pe rotated), in x's dtype."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope = cfg.qk_nope_head_dim
    q = (x @ p["wq"].to(x.dtype)).view(b, s, h, -1)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = kv_norm(kv[..., :r], p["kv_norm"])
    k_pe = rope(kv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    q_pe = rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe, torch.cat([c_kv, k_pe], dim=-1)


def _heads_of(wkv_b, cfg: ArchConfig):
    """``wkv_b`` (r, H * (nope + v)) as each head's W_UK (r, H, nope) and
    W_UV (r, H, v), views."""
    w = wkv_b.unflatten(-1, (cfg.n_heads, -1))
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def attention(x, p, cfg: ArchConfig, positions):
    """Full-sequence (train/prefill) latent attention in the decompressed
    form. Returns (out (B, S, D), the latent rows (B, S, r + rope))."""
    with tracing.span("mla.prefill"):
        b, s, _ = x.shape
        h, r = cfg.n_heads, cfg.kv_lora_rank
        q_nope, q_pe, latent = project(x, p, cfg, positions)
        kv = (latent[..., :r] @ p["wkv_b"].to(x.dtype)).view(b, s, h, -1)
        k_nope, v = kv[..., :cfg.qk_nope_head_dim], \
            kv[..., cfg.qk_nope_head_dim:]
        k_pe = latent[..., None, r:].expand(b, s, h, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        width = q.shape[-1]
        # _sdpa scales by 1/sqrt(width) and takes values of the keys' width
        factor = softmax_scale(cfg) * math.sqrt(width)
        if factor != 1.0:
            q = q * factor
        v = F.pad(v, (0, width - cfg.v_head_dim))
        idx = torch.arange(s, dtype=torch.int32, device=x.device)
        out = L._sdpa(q, k, v, rows=idx, cols=idx, causal=True)
        out = out.view(b, s, h, width)[..., :cfg.v_head_dim]
        out = out.reshape(b, s, h * cfg.v_head_dim) @ p["wo"].to(x.dtype)
        return L.residual_branch(out), latent


def absorbed(q, cache, pos, lat: int, scale: float):
    """The absorbed attention of one query a row in PyTorch: ``q`` (B, 1,
    H, W) (each head's q_lat ‖ q_pe) over the latent rows ``cache`` (B, T,
    W) at positions 0..pos (an int, or a 0-dim tensor on the cache's
    device); the scores in f32, the probabilities rounded to the cache's
    dtype before their product with the rows' first ``lat`` dims, summed
    in f32. Returns (B, 1, H, lat) in q's dtype."""
    t = cache.shape[1]
    sc = torch.einsum("bhw,btw->bht", q[:, 0].float(), cache.float()) * scale
    cols = torch.arange(t, device=cache.device)
    sc = sc.masked_fill((cols > pos)[None, None], -math.inf)
    m = sc.amax(dim=-1, keepdim=True)
    pr = torch.exp(sc - m)
    out = torch.einsum("bht,btc->bhc", pr.to(cache.dtype).float(),
                       cache[..., :lat].float())
    return (out / pr.sum(dim=-1, keepdim=True)).to(q.dtype)[:, None]


def _decode_kernel_applies(q, cache) -> bool:
    """Whether one query a row takes the latent decode kernel
    (``kernels/mla_decode``): CUDA tensors that are not DTensors, no
    gradient to keep, q and the cache in bf16 at the widths the kernel
    takes. Elsewhere :func:`absorbed` runs. Where the gate is open, the
    wrapper's own checks raise rather than change path."""
    if q.shape[1] != 1 or q.device.type != "cuda" or any(
            L._is_dtensor(y) for y in (q, cache)):
        return False
    if torch.is_grad_enabled() and (q.requires_grad or cache.requires_grad):
        return False
    return (q.dtype == cache.dtype == torch.bfloat16
            and decode_kernel.takes(q.shape[2], q.shape[3]))


def _prologue_kernel_applies(x, p, cfg: ArchConfig, cache) -> bool:
    """Whether one query a row takes the attention prologue kernel
    (``kernels/decode_rope``, its latent mode) from the projections to the
    latent row and the query: CUDA tensors that are not DTensors, no
    gradient to keep, x, the attention's weights and the cache in bf16, at
    latent widths the kernel takes. Elsewhere :func:`project`,
    :func:`write_row` and the ``cat`` of the query run as ops. Where the
    gate is open, the wrapper's own checks raise rather than change
    path."""
    tensors = [x, cache, p["wq"], p["wkv_a"], p["kv_norm"], p["wkv_b"]]
    if x.shape[1] != 1 or x.device.type != "cuda" or any(
            L._is_dtensor(t) for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return (all(t.dtype == torch.bfloat16 for t in tensors)
            and rope_kernel.takes_mla(cfg.kv_lora_rank, cfg.qk_rope_head_dim))


def _absorb(q_nope, w_uk):
    """Each head's q_nope (B, 1, H, nope) through its W_UK (r, H, nope):
    (B, H, r), a view of the (H, B, r) product."""
    return torch.matmul(q_nope[:, 0].transpose(0, 1),
                        w_uk.permute(1, 2, 0)).transpose(0, 1)


def write_row(cache, row, pos) -> None:
    """The step's latent rows (B, 1, W) into ``cache`` (B, T, W) at ``pos``
    (an int, or a 0-dim int32 tensor on the device: its write is an
    ``index_copy_``, kept inside the cache as ``dynamic_update_slice``
    clamps)."""
    t = cache.shape[1]
    if torch.is_tensor(pos):
        slot = torch.clamp(pos, max=t - 1).long().reshape(1)
        cache.index_copy_(1, slot, row.to(cache.dtype))
    else:
        pos = min(int(pos), t - 1)
        cache[:, pos:pos + 1] = row.to(cache.dtype)


def attention_decode(x, p, cfg: ArchConfig, cache, pos):
    """Single-token decode in the absorbed form: x (B, 1, D); ``cache`` (B,
    T, r + rope) the layer's latent rows, this step's written in place at
    ``pos`` (an int or a 0-dim int32 tensor on the cache's device, as a
    step captured as a CUDA graph feeds it). Returns (B, 1, D)."""
    with tracing.span("attention.decode"):
        b, s, _ = x.shape
        w_uk, w_uv = _heads_of(p["wkv_b"].to(x.dtype), cfg)
        nope = cfg.qk_nope_head_dim
        if _prologue_kernel_applies(x, p, cfg, cache):
            q, kv = x @ p["wq"], x @ p["wkv_a"]
            with tracing.span("mla.absorb"):
                q_lat = _absorb(q.view(b, s, cfg.n_heads, -1)[..., :nope],
                                w_uk)
                q = rope_kernel.decode_rope_mla(
                    q, kv, p["kv_norm"], q_lat, cache, pos, cfg.rope_theta,
                    nope, KV_NORM_EPS)
        else:
            positions = (pos.expand(b, s) if torch.is_tensor(pos) else
                         torch.full((b, s), int(pos), dtype=torch.int32,
                                    device=x.device))
            q_nope, q_pe, latent = project(x, p, cfg, positions)
            write_row(cache, latent, pos)
            with tracing.span("mla.absorb"):
                q = torch.cat([_absorb(q_nope, w_uk), q_pe[:, 0]],
                              dim=-1)[:, None]
        scale = softmax_scale(cfg)
        if _decode_kernel_applies(q, cache):
            o_lat = decode_kernel.mla_decode(q, cache, pos, scale)
        else:
            o_lat = absorbed(q, cache, pos, cfg.kv_lora_rank, scale)
        with tracing.span("mla.out"):
            # (H, B, r) @ (H, r, v): each head's latent output through W_UV
            o = torch.matmul(o_lat[:, 0].transpose(0, 1),
                             w_uv.transpose(0, 1)).transpose(0, 1)
            return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    """Every layer's latent rows, (L, B, T, r + rope)."""
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return {"latent": torch.zeros((cfg.n_layers, batch, max_len, width),
                                  dtype=dtype, device=device)}
