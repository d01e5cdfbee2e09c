"""Mamba-2 (SSD — state-space duality) blocks, the JAX package's
``models/ssm.py`` ported.

The chunked SSD form computes the selective SSM as block matmuls: an
intra-chunk quadratic part plus an inter-chunk state recurrence (here a
loop over the chunks, the reference's ``lax.scan``). Decode is an O(1)
state update per token: the cache holds each layer's last ``conv_kernel -
1`` conv inputs and its SSM state, whatever the context length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_state


def _init_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_layers,)
    d = cfg.d_model
    d_in, h, n = _dims(cfg)
    conv_dim = d_in + 2 * n
    dev = generator.device

    def full(shape, value):
        return torch.full(stack + shape, value, dtype=torch.float32,
                          device=dev)

    return {
        "ln": L.init_norm(d, generator, stack),
        # in_proj -> [z (d_in), x (d_in), B (n), C (n), dt (h)]
        "in_proj": L._dense_init(stack + (d, 2 * d_in + 2 * n + h),
                                 generator),
        "conv_w": L._dense_init(stack + (cfg.conv_kernel, conv_dim),
                                generator, scale=0.1),
        "conv_b": full((conv_dim,), 0.0),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)).expand(
            stack + (h,)).clone(),
        "d_skip": full((h,), 1.0),
        "dt_bias": full((h,), 0.0),
        "gate_norm": L.init_norm(d_in, generator, stack),
        "out_proj": L._dense_init(stack + (d_in, d), generator),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> T.Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    tree = {
        **L.init_embedding(cfg, generator),
        "layers": _init_layers(cfg, generator),
        "final_norm": L.init_norm(cfg.d_model, generator),
    }
    return T.Model(cfg, tree, forward).to(device)


def causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, C); w (K, C)."""
    k = w.shape[0]
    xp = L.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    return out + b.to(x.dtype)


def ssd_chunked(xdt, da, b_mat, c_mat, chunk: int, init_state=None):
    """Chunk-parallel SSD (Mamba-2, alg. from arXiv:2405.21060 §6).

    xdt (B,S,H,P) — inputs pre-multiplied by dt; da (B,S,H) = dt*A (<=0);
    b_mat/c_mat (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, l, h, p = xdt.shape
    n = b_mat.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        xdt = L.pad(xdt, (0, 0, 0, 0, 0, pad))
        da = L.pad(da, (0, 0, 0, pad))
        b_mat = L.pad(b_mat, (0, 0, 0, pad))
        c_mat = L.pad(c_mat, (0, 0, 0, pad))
    nc = (l + pad) // q
    dtype = xdt.dtype
    xc = xdt.reshape(bsz, nc, q, h, p)
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)
    dac = da.reshape(bsz, nc, q, h).permute(0, 1, 3, 2)       # (B,nc,H,Q)
    cs = L.cumsum(dac.float(), dim=-1)

    # intra-chunk (quadratic within chunk)
    seg = cs[..., :, None] - cs[..., None, :]                 # (B,nc,H,Q,Q)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    lmat = torch.exp(seg.masked_fill(~tril, -math.inf)).to(dtype)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, lmat, xc)

    # inter-chunk state passing
    decay_to_end = torch.exp(cs[..., -1:] - cs).to(dtype)     # (B,nc,H,Q)
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", bc, decay_to_end, xc)
    chunk_decay = torch.exp(cs[..., -1]).to(dtype)            # (B,nc,H)

    s = (init_state if init_state is not None
         else xdt.new_zeros((bsz, h, p, n)))
    s_prevs = []
    for c in range(nc):  # the state entering chunk c, then chunk c's update
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                     # (B,nc,H,P,N)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, s_prevs,
                         torch.exp(cs).to(dtype))
    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)
    return y[:, :l], s


def _split_proj(zxbcdt, cfg: ArchConfig):
    d_in, h, n = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in:2 * d_in]
    b_mat = zxbcdt[..., 2 * d_in:2 * d_in + n]
    c_mat = zxbcdt[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xs, b_mat, c_mat, dt


def _ssm_seq(x, lp, cfg: ArchConfig, round_dt: bool):
    """One Mamba-2 block over a full sequence. x (B,S,D). Returns (out,
    conv_tail, final_state): the last ``conv_kernel - 1`` conv inputs and
    the SSM state after the last token, the decode cache's entries.
    ``round_dt``: dt is rounded to x's dtype before ``dt * A``, as the
    reference's ``ssm_block`` does and its ``prefill`` does not."""
    d_in, h, n = _dims(cfg)
    zxbcdt = x @ lp["in_proj"].to(x.dtype)
    z, xs, b_mat, c_mat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, b_mat, c_mat], dim=-1)
    conv_out = F.silu(causal_conv(conv_in, lp["conv_w"], lp["conv_b"]))
    conv_tail = conv_in[:, -(cfg.conv_kernel - 1):]
    xs = conv_out[..., :d_in]
    b_mat = conv_out[..., d_in:d_in + n]
    c_mat = conv_out[..., d_in + n:]
    dt = F.softplus(dt.float() + lp["dt_bias"])               # (B,S,H) f32
    if round_dt:
        dt = dt.to(x.dtype).float()
    a = -torch.exp(lp["a_log"].float())                       # (H,)
    da = dt * a                                               # (B,S,H)
    xh = L.split_heads(xs, h, cfg.ssm_head_dim)
    xdt = xh * dt.to(x.dtype)[..., None]
    y, final = ssd_chunked(xdt, da, b_mat, c_mat, cfg.ssm_chunk)
    y = y + xh * lp["d_skip"].to(x.dtype)[:, None]
    y = L.merge_heads(y)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
    return L.residual_branch(y @ lp["out_proj"].to(x.dtype)), conv_tail, final


def ssm_block(x, lp, cfg: ArchConfig):
    """One Mamba-2 block over a full sequence. x (B,S,D)."""
    return _ssm_seq(x, lp, cfg, round_dt=True)[0]


def _layer(x, lp, cfg: ArchConfig):
    return L.shard_act(
        x + ssm_block(L.rms_norm(x, lp["ln"], cfg.norm_eps), lp, cfg),
        seq_model=True)


def forward(params: T.Model, tokens, cfg: ArchConfig, *,
            remat: str = "full"):
    """tokens (B, S) -> logits (B, S, V). ``remat``: each layer's policy
    under autograd (:func:`~repro_torch.models.transformer.remat_layer`)."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    layer = T.remat_layer(_layer, remat)
    for lp in T.unbind_layers(params["layers"]):
        x = layer(x, lp, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


# -------------------------------------------------------------------- decode --

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    del max_len  # O(1) state — the SSM long-context advantage
    dtype = dtype or T.DTYPES[cfg.dtype]
    d_in, h, n = _dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_head_dim, n),
                             dtype=dtype, device=device),
    }


def _ssm_block_decode(x, lp, cfg: ArchConfig, conv_c, state):
    """x (B, D) single token. Returns (out, conv_c, state)."""
    d_in, h, n = _dims(cfg)
    zxbcdt = x @ lp["in_proj"].to(x.dtype)
    z, xs, b_mat, c_mat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, b_mat, c_mat], dim=-1)           # (B, conv_dim)
    window = torch.cat([conv_c, conv_in[:, None]], dim=1)     # (B,K,C)
    w = lp["conv_w"].to(x.dtype)
    conv_out = F.silu((window * w[None]).sum(dim=1)
                      + lp["conv_b"].to(x.dtype))
    conv_c = window[:, 1:]
    xs = conv_out[..., :d_in]
    b_mat = conv_out[..., d_in:d_in + n]
    c_mat = conv_out[..., d_in + n:]
    dt = F.softplus(dt.float() + lp["dt_bias"])               # (B,H)
    a = -torch.exp(lp["a_log"].float())
    da = torch.exp(dt * a).to(x.dtype)                        # (B,H)
    xh = xs.reshape(-1, h, cfg.ssm_head_dim)
    xdt = xh * dt.to(x.dtype)[..., None]
    state = (state * da[..., None, None]
             + torch.einsum("bn,bhp->bhpn", b_mat, xdt))
    y = torch.einsum("bn,bhpn->bhp", c_mat, state)
    y = y + xh * lp["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(-1, d_in)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
    return y @ lp["out_proj"].to(x.dtype), conv_c, state


@torch.no_grad()
def decode_step(params: T.Model, cache, tokens, pos: int, cfg: ArchConfig):
    """One-token decode; each layer's conv inputs and state are written
    into the cache in place. ``pos`` is unused: the state carries all
    history."""
    del pos
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])[:, 0]  # (B, D)
    layers = T.unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        out, cache["conv"][i], cache["state"][i] = _ssm_block_decode(
            h, lp, cfg, cache["conv"][i], cache["state"][i])
        x = x + out
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), cache


@torch.no_grad()
def prefill(params: T.Model, tokens, cfg: ArchConfig, max_len: int):
    """Forward + final state capture for serving. Returns (logits,
    cache)."""
    del max_len
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    convs, states = [], []
    layers = T.unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        out, conv_tail, final = _ssm_seq(
            L.rms_norm(x, lp["ln"], cfg.norm_eps), lp, cfg, round_dt=False)
        x = x + out
        convs.append(conv_tail)
        states.append(final)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg), {"conv": torch.stack(convs),
                                       "state": torch.stack(states)}
