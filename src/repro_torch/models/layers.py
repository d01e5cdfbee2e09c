"""Shared model building blocks (the JAX package's ``models/layers.py``,
ported to plain functions on tensors).

Parameters are f32 ("master" precision); compute casts to the config dtype
(bf16 by default) at every projection, as the reference does. The model's
projections are ``@`` and its attention the chunked online softmax of
:func:`_sdpa`, in plain PyTorch: the port's tuned CUDA kernels are reached
through dispatch and tuning (``core/dispatch.py``), not from inside the
model, as in the reference.

Per-layer parameters arrive here as dicts of tensors (``p["wq"]`` ...),
one layer's slice of the stacked ``(L, ...)`` parameters of
:mod:`repro_torch.models.transformer`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

# ----------------------------------------------------- activation sharding --
# The reference pins the batch sharding of activations GSPMD would otherwise
# drop (layer carries, loss-region logits). The launch layer installs the
# mesh axes here and the models pin the residual stream / logits with
# explicit constraints: on a DTensor, a redistribution to the placements
# the reference's ``with_sharding_constraint`` names. No-op when unset or on
# a plain tensor (single-device code).
#
# ``seq_model`` additionally shards the sequence dim of the between-layer
# residual stream over the model axis — Megatron-style sequence
# parallelism, at the cost of a gather/scatter pair per layer.
_BATCH_AXES: tuple | None = None
_BATCH_SIZE: int = 1
_MODEL_AXIS: str | None = None
_MODEL_SIZE: int = 1
_SEQ_SHARD: bool = True


def set_activation_sharding(batch_axes, batch_size, model_axis="model",
                            model_size=1, seq_shard=True):
    global _BATCH_AXES, _BATCH_SIZE, _MODEL_AXIS, _MODEL_SIZE, _SEQ_SHARD
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _BATCH_SIZE = batch_size
    _MODEL_AXIS = model_axis
    _MODEL_SIZE = model_size
    _SEQ_SHARD = seq_shard


def clear_activation_sharding():
    global _BATCH_AXES, _MODEL_AXIS
    _BATCH_AXES = None
    _MODEL_AXIS = None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sum_partial(x):
    """A DTensor's pending reductions (``Partial`` placements) carried out,
    its shards kept. A gather along a sharded dim (the gold logit from
    vocab-sharded logits) leaves a masked partial, whose mask DTensor
    misapplies when a later op moves the shards and reduces in one
    redistribution; summing it at once avoids that."""
    from torch.distributed.tensor import Replicate

    if not _is_dtensor(x) or not any(q.is_partial() for q in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if q.is_partial() else q for q in x.placements])


def _constrain(x, axes: dict):
    """``x`` (a DTensor) redistributed so that each tensor dim ``d`` of
    ``axes`` (``{d: axis names}``) lies over exactly those mesh axes. A mesh
    dim that shards a constrained dim otherwise is replicated; one that
    shards an unconstrained dim keeps it (the reference's ``UNCONSTRAINED``);
    a pending reduction (``Partial``) is carried out."""
    from torch.distributed.tensor import Replicate, Shard

    want = {name: d for d, names in axes.items() for name in names}
    mesh = x.device_mesh
    new = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if name in want and mesh.size(i) > 1:  # as sharding.placements
            new.append(Shard(want[name]))
        elif name in want:
            new.append(Replicate())
        elif p.is_partial() or (p.is_shard() and p.dim % x.ndim in axes):
            new.append(Replicate())
        else:
            new.append(p)
    if tuple(new) == tuple(x.placements):
        return x
    return x.redistribute(mesh, new)


def by_rows(fn, x, *args):
    """``fn(x, *args)`` for a computation that is independent per batch
    row (dim 0 of ``x`` and of every tensor in ``args``) and needs every
    other dim whole. On a DTensor it runs on each rank's rows: ``x`` and
    each DTensor of ``args`` redistributed to keep only ``x``'s batch
    shards, ``fn`` applied to the local rows, and what it returns (a
    tensor or a tuple) made DTensors of the same placements (autograd
    flows through). For ops DTensor has no sharding rule for
    (``searchsorted``) or shards badly (a scatter into a buffer, which it
    gathers whole over the batch shards)."""
    if not _is_dtensor(x):
        return fn(x, *args)
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    rows = [q if q.is_shard(0) else Replicate() for q in x.placements]
    out = fn(_local(x, mesh, rows), *(
        _local(a, mesh, rows) if _is_dtensor(a) else a for a in args))
    wrap = lambda o: (_from_local(o, mesh, rows, (x.shape[0], *o.shape[1:]))
                      if torch.is_tensor(o) else o)
    return wrap(out) if torch.is_tensor(out) else tuple(map(wrap, out))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    shard taken out of a sharded DTensor must hand back a gradient laid
    out as the strides DTensor derives for the shard (contiguous ones), or
    DTensor's later views of it fail."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _local(x, mesh, placements, grad_placements=None):
    """``x`` (a DTensor) laid out by ``placements``, as this rank's shard;
    autograd flows through, the shard's gradient taken as laid out by
    ``grad_placements`` (``placements`` when None)."""
    local = x.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)
    if any(q.is_shard() for q in placements):
        return _ContiguousGrad.apply(local)
    return local  # replicated: the shard's strides are the DTensor's


def _from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous, as the local shard is
    made) from each rank's ``local`` shard; autograd flows through."""
    from torch.distributed.tensor import DTensor

    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _heads_local(fn, q, k, v, rows, *args):
    """``fn(q, k, v, rows, *args)`` for attention (q (B, S, Hq, D), k and v
    (B, T, Hkv, D), rows (S,) the queries' global positions -> (B, S,
    Hq*D)), which is independent per batch row, query head and query row.
    On DTensors it runs on each rank's shard. The batch keeps its shards.
    The first other mesh dim of size > 1 splits the query heads where it
    divides them (contiguous blocks), else the query rows where it divides
    them; every other mesh dim replicates. With the heads split, each rank
    reads the KV heads its block uses (query head h reads KV head h //
    group, the reference's layout after its ``jnp.repeat``): sharded with
    the query heads where the mesh dim divides both counts, else taken
    whole and indexed. With the rows split, each rank attends over its
    rows, at their global positions, against the whole K/V, and the output
    rows are gathered after. A K/V taken whole returns its gradient as a
    partial sum over that mesh dim. The output is laid out as q's shard
    (its rows whole); DTensor never sees the attention's own ops."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qp, kvp, kvg = [], [], []  # kvg: the K/V shards' gradients' layout
    split = None  # (mesh dim, its size, "heads" or "rows")
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p.is_shard(0):
            layout = (Shard(0), Shard(0), Shard(0))
        elif split is None and n > 1 and hq % n == 0:
            split = (i, n, "heads")
            layout = ((Shard(2), Shard(2), Shard(2)) if hkv % n == 0
                      else (Shard(2), Replicate(), Partial()))
        elif split is None and n > 1 and s % n == 0:
            split = (i, n, "rows")
            layout = (Shard(1), Replicate(), Partial())
        else:
            layout = (Replicate(), Replicate(), Replicate())
        for placements, pl in zip((qp, kvp, kvg), layout):
            placements.append(pl)
    ql = _local(q, mesh, qp)
    kl, vl = (_local(t, mesh, kvp, kvg) for t in (k, v))
    if split is not None:
        i, n, how = split
        r = mesh.get_local_rank(i)
        if how == "rows":
            rows = rows[r * (s // n):(r + 1) * (s // n)]
        elif hkv % n:  # this block's KV heads, one per query head
            heads = torch.arange(r * (hq // n), (r + 1) * (hq // n),
                                 device=kl.device) // (hq // hkv)
            kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
    out = _from_local(fn(ql, kl, vl, rows, *args), mesh, qp, (b, s, hq * d))
    if split is not None and split[2] == "rows":
        # the rows gathered again before the output projection, which
        # DTensor 2.11 cannot run with the sequence sharded
        out = _whole_sequence(out)
    return out


def _on_shards(fn, x, dims, shape):
    """``fn`` (an op along ``dims``, independent across the other dims) of
    each rank's shard of the DTensor ``x``, as a DTensor of global
    ``shape``; a mesh dim that shards one of ``dims`` is replicated
    first. For ops whose sharding DTensor 2.11 gets wrong (the pad's
    redistribution, an IndexError)."""
    from torch.distributed.tensor import Replicate

    placements = [Replicate() if q.is_shard() and q.dim % x.ndim in dims
                  else q for q in x.placements]
    return _from_local(fn(_local(x, x.device_mesh, placements)),
                       x.device_mesh, placements, tuple(shape))


def columns(w, start: int, stop: int, shard: bool = True):
    """``w[..., start:stop]``, a weight's columns. On a DTensor whose last
    dim a mesh dim shards, the columns are taken from the weight gathered
    over that mesh dim, then laid back out over it where ``shard`` asks
    and its size divides their width (else kept whole: each rank computes
    the product with them)."""
    if not _is_dtensor(w):
        return w[..., start:stop]
    from torch.distributed.tensor import Replicate, Shard

    mesh, last = w.device_mesh, w.ndim - 1
    dims = [i for i, q in enumerate(w.placements)
            if q.is_shard() and q.dim % w.ndim == last]
    if not dims:
        return w[..., start:stop]
    whole = w.redistribute(mesh, [Replicate() if i in dims else q
                                  for i, q in enumerate(w.placements)])
    piece = whole[..., start:stop]
    return piece.redistribute(mesh, [
        Shard(last) if i in dims and shard
        and (stop - start) % mesh.size(i) == 0 else q
        for i, q in enumerate(piece.placements)])


def pad(x, widths):
    """``F.pad(x, widths)`` with zeros, on DTensors shard by shard."""
    if not _is_dtensor(x):
        return F.pad(x, widths)
    shape = list(x.shape)
    for i in range(len(widths) // 2):
        shape[x.ndim - 1 - i] += widths[2 * i] + widths[2 * i + 1]
    return _on_shards(lambda t: F.pad(t, widths), x,
                      {d for d in range(x.ndim) if shape[d] != x.shape[d]},
                      shape)


def experts_local(fn, x, weights: dict, *args):
    """``fn(x, weights, *args)`` for the experts' FFN (x (B, E, C, D),
    each weight (E, ...) -> (B, E, C, D)), which is independent per batch
    row and per expert. On DTensors it runs on each rank's shard: the
    batch keeps its shards, the experts are split over the model axis
    where it divides them (the reference's EP), every other mesh dim
    replicates (the weights' FSDP shards are gathered); the output is laid
    out as ``x``'s shard. DTensor never sees the experts' einsums (its view
    of their permuted operands fails on local shards)."""
    if not _is_dtensor(x):
        return fn(x, weights, *args)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp, wp, grads = [], [], []  # grads: the weights' gradients' layout
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if p.is_shard(0):  # each batch shard adds its rows' gradient
            layout = (Shard(0), Replicate(), Partial())
        elif (name == _MODEL_AXIS and mesh.size(i) > 1
              and x.shape[1] % mesh.size(i) == 0):
            layout = (Shard(1), Shard(0), Shard(0))
        else:
            layout = (Replicate(), Replicate(), Replicate())
        for placements, q in zip((xp, wp, grads), layout):
            placements.append(q)
    out = fn(_local(x, mesh, xp),
             {k: _local(w, mesh, wp, grads) for k, w in weights.items()},
             *args)
    return _from_local(out, mesh, xp, (*x.shape[:3], out.shape[-1]))


def shard_expert(x):
    """Constrain (B, E, ...) expert-parallel buffers: batch over DP axes,
    experts over the model axis (EP)."""
    if _BATCH_AXES is None or x.ndim < 2 or not _is_dtensor(x):
        return x
    axes = {}
    if x.shape[0] % _BATCH_SIZE == 0 and x.shape[0] >= _BATCH_SIZE:
        axes[0] = _BATCH_AXES
    if x.shape[1] % _MODEL_SIZE == 0 and x.shape[1] >= _MODEL_SIZE:
        axes[1] = (_MODEL_AXIS,)
    return _constrain(x, axes)


class _GradLaidOutAsInput(torch.autograd.Function):
    """The identity on a DTensor, whose backward lays the gradient out as
    the input was (a pending sum as replicated)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if q.is_partial() else q
                               for q in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        if _is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            return grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def residual_branch(y):
    """A sublayer's output (attention's, the MLP's, ...), before it joins
    the residual stream. On a DTensor its gradient comes back laid out as
    ``y`` is: the stream's sequence-sharded gradient is gathered before it
    reaches the sublayer's last projection, whose backward DTensor 2.11
    cannot fold (batch and sequence both sharded, as in the forward of
    :func:`_whole_sequence`)."""
    if not _is_dtensor(y):
        return y
    return _GradLaidOutAsInput.apply(y)


def shard_act(x, last_dim_model: bool = False, seq_model: bool = False):
    """Constrain (B, [S,] ..., D) activations: batch over the DP axes;
    optionally the seq dim (residual carries) or the last dim (padded vocab
    logits) over the model axis. Dims that don't divide stay unconstrained."""
    if _BATCH_AXES is None or x.ndim < 2 or not _is_dtensor(x):
        return x
    axes = {}
    if x.shape[0] % _BATCH_SIZE == 0 and x.shape[0] >= _BATCH_SIZE:
        axes[0] = _BATCH_AXES
    if (seq_model and _SEQ_SHARD and x.ndim >= 3
            and x.shape[1] % _MODEL_SIZE == 0 and x.shape[1] >= _MODEL_SIZE):
        axes[1] = (_MODEL_AXIS,)
    if last_dim_model and x.shape[-1] % _MODEL_SIZE == 0:
        axes[x.ndim - 1] = (_MODEL_AXIS,)
    return _constrain(x, axes)


# --------------------------------------------------------------------- init --


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device (torch has
    none): the init functions allocate there, shapes and dtypes only, and
    draw nothing. The counterpart of the reference's ``jax.eval_shape`` of
    an init."""
    device = torch.device("meta")


def _dense_init(shape, generator: torch.Generator, scale=None):
    """f32 normal of ``shape`` scaled by ``1/sqrt(fan_in)`` (``shape[-2]``:
    the stacked layer dim, where present, leads), drawn from
    ``generator`` on its device. Scaled in place: a stacked expert tensor
    (Qwen1.5-MoE's is 17.7 GB in f32) is never held twice. On a
    :class:`MetaGenerator` nothing is drawn."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


def init_norm(d: int, generator: torch.Generator,
              stack: tuple[int, ...] = ()):
    """A norm's f32 scale of ones, on ``generator``'s device."""
    return torch.ones((*stack, d), dtype=torch.float32,
                      device=generator.device)


# --------------------------------------------------------------------- norms --

def _whole_sequence(x):
    """``x`` (B, S, ...) with its sequence gathered where a mesh dim
    shards it: a norm's output, before the sublayer's projections
    (Megatron's sequence parallelism gathers there; the residual stream
    between layers stays sharded, ``shard_act(seq_model=True)``). DTensor
    cannot flatten batch and sequence into a matmul's rows when both are
    sharded (torch 2.11 refuses; 2.13 plans a strided shard)."""
    if not _is_dtensor(x) or x.ndim < 3 or not any(
            q.is_shard(1) for q in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if q.is_shard(1) else q for q in x.placements])


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return _whole_sequence(out.to(dtype))


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return _whole_sequence(out.to(dtype))


# ---------------------------------------------------------------------- rope --

def _rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def _rotate(x, angles):
    """Rotate the two halves of ``x``'s last dim by ``angles`` (..., S,
    D/2), broadcast over the head dim, in f32."""
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x (..., S, H, D); positions (..., S) integer."""
    d = x.shape[-1]
    freqs = torch.as_tensor(_rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    return _rotate(x, angles)


def apply_mrope(x, positions, theta: float, sections: tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL): ``positions`` is (B, 3, S) — one position
    stream per (temporal, height, width) — and the head_dim/2 frequency
    bands are split into ``sections`` consuming their own stream."""
    d = x.shape[-1]
    freqs = torch.as_tensor(_rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)  # (D/2,)
    # section id per frequency band
    sec_id = np.zeros(d // 2, np.int64)
    start = 0
    for i, s in enumerate(sections):
        sec_id[start:start + s] = i
        start += s
    sec_id = torch.as_tensor(sec_id, device=x.device)
    pos = positions.float().index_select(1, sec_id)  # (B, D/2, S)
    angles = pos.movedim(1, -1) * freqs  # (B, S, D/2)
    return _rotate(x, angles)


# ----------------------------------------------------------------- attention --

def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   stack: tuple[int, ...] = ()):
    d = cfg.d_model
    return {
        "wq": _dense_init((*stack, d, cfg.q_dim), generator),
        "wk": _dense_init((*stack, d, cfg.kv_dim), generator),
        "wv": _dense_init((*stack, d, cfg.kv_dim), generator),
        "wo": _dense_init((*stack, cfg.q_dim, d), generator),
    }


def split_heads(y, heads: int, head_dim: int):
    """``y`` (..., heads * head_dim) as (..., heads, head_dim). On a
    DTensor, a mesh dim that shards the last dim but does not divide
    ``heads`` is replicated first (:func:`_heads_local` then splits the
    query rows or indexes the KV heads over it): DTensor cannot unflatten
    an uneven shard (the reference's GSPMD lays one out itself)."""
    if _is_dtensor(y):
        from torch.distributed.tensor import Replicate

        mesh = y.device_mesh
        new = [Replicate() if q.is_shard() and q.dim % y.ndim == y.ndim - 1
               and heads % mesh.size(i) else q
               for i, q in enumerate(y.placements)]
        if tuple(new) != tuple(y.placements):
            y = y.redistribute(mesh, new)
    return y.reshape(*y.shape[:-1], heads, head_dim)


def merge_heads(y):
    """``y`` (..., heads, head_dim) as (..., heads * head_dim). On a
    DTensor each rank merges its own shard, the heads' shards kept (the
    head dim unsharded): the backward of DTensor's own merge would
    unflatten a gradient sharded over a mesh dim that :func:`split_heads`
    replicated."""
    shape = (*y.shape[:-2], y.shape[-2] * y.shape[-1])
    if not _is_dtensor(y) or any(
            q.is_shard() and q.dim % y.ndim == y.ndim - 1
            for q in y.placements):
        return y.reshape(shape)
    local = _local(y, y.device_mesh, y.placements)
    return _from_local(local.reshape(*local.shape[:-2], -1), y.device_mesh,
                       y.placements, shape)


def _qkv(x, p, cfg: ArchConfig):
    q = split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"].to(x.dtype), cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(x @ p["wv"].to(x.dtype), cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


# True while a layer body runs under a checkpoint of the whole layer
# (``transformer.remat_layer``: remat "full" or "dots"), in its forward and
# in its recompute alike.
_REMAT = False


def in_remat(body):
    """``body`` (a layer) marked, while it runs, as rematerialized by its
    backward (:data:`_REMAT`)."""
    @functools.wraps(body)
    def run(*args, **kwargs):
        global _REMAT
        outer, _REMAT = _REMAT, True
        try:
            return body(*args, **kwargs)
        finally:
            _REMAT = outer
    return run


# Chunked online-softmax attention: the same KV-blocking the flash kernel
# implements, a loop over key chunks that never materializes (S, T) scores.
ATTN_CHUNK = 1024
_COL_SENTINEL = 2**30  # padded key slots: fails both validity and causality


def _masked_scores(qf, kk, cc, rows_b, scale: float, window: int,
                   causal: bool):
    """One key chunk's f32 scores (B, Hq, S, C), -1e30 where a key is not
    visible, and the visibility: keys ``kk`` (B, C, Hq, D) at global
    positions ``cc`` (C,), queries ``qf`` at ``rows_b`` (1, 1, S, 1)."""
    sc = torch.einsum("bshd,bchd->bhsc", qf, kk.float()) * scale
    cc_b = cc[None, None, None, :]
    pred = cc_b < _COL_SENTINEL
    if causal:
        pred = pred & (cc_b <= rows_b)
        if window >= 0:
            pred = pred & (rows_b - cc_b < window)
    return torch.where(pred, sc, -1e30), pred


def _online_softmax(q, k, v, rows, cols, window: int, causal: bool, c: int):
    """:func:`_sdpa`'s loop over ``c``-key chunks: q (B, S, Hq, D), k and v
    (B, T, Hq, D) with T a multiple of ``c``. Returns the rows' running
    max and sum (B, Hq, S, 1) and the f32 output (B, Hq, S, D)."""
    b, s, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    rows_b = rows[None, None, :, None]  # (1,1,S,1)
    qf = q.float()
    m = torch.full((b, hq, s, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], c):
        vv = v[:, start:start + c]
        sc, _ = _masked_scores(qf, k[:, start:start + c],
                               cols[start:start + c], rows_b, scale, window,
                               causal)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhsc,bchd->bhsd", p.to(vv.dtype).float(), vv.float())
        m = m_new
    return m, l, acc / torch.clamp(l, min=1e-20)


class _Attention(torch.autograd.Function):
    """:func:`_online_softmax`'s output under autograd, with the
    flash-attention backward: the forward keeps q, k, v, the f32 output and
    the rows' max and sum, and the backward recomputes each chunk's scores
    and probabilities from them (the reference's ``jax.checkpoint(body,
    nothing_saveable)``), never keeping a (B, Hq, S, C) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, rows, cols, window: int, causal: bool,
                c: int):
        m, l, out = _online_softmax(q, k, v, rows, cols, window, causal, c)
        ctx.save_for_backward(q, k, v, rows, cols, out, m, l)
        ctx.args = (window, causal, c)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, rows, cols, out, m, l = ctx.saved_tensors
        window, causal, c = ctx.args
        scale = 1.0 / math.sqrt(q.shape[-1])
        rows_b = rows[None, None, :, None]
        qf = q.float()
        # softmax's backward: dS = P * (dP - rowsum(dO * O))
        d_sum = (d_out * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        for start in range(0, k.shape[1], c):
            kk, vv = k[:, start:start + c], v[:, start:start + c]
            sc, pred = _masked_scores(qf, kk, cols[start:start + c], rows_b,
                                      scale, window, causal)
            p = torch.exp(sc - m) / l
            dv[:, start:start + c] = torch.einsum(
                "bhsc,bhsd->bchd", p.to(vv.dtype).float(), d_out)
            # the forward cast the probabilities to v's dtype: their
            # cotangent is rounded to it
            dp = torch.einsum("bhsd,bchd->bhsc", d_out,
                              vv.float()).to(vv.dtype).float()
            ds = torch.where(pred, p * (dp - d_sum), 0.0) * scale
            dq += torch.einsum("bhsc,bchd->bshd", ds, kk.float())
            dk[:, start:start + c] = torch.einsum("bhsc,bshd->bchd", ds, qf)
        return dq.to(q.dtype), dk, dv, None, None, None, None, None


def _sdpa(q, k, v, rows, cols, window: int = -1, causal: bool = True):
    """q (B,S,Hq,D); k/v (B,T,Hkv,D); rows (S,)/cols (T,) global positions.

    ``window``: negative = unlimited; else sliding window.
    Returns (B, S, Hq*D) in q.dtype. Scores and the running state are f32;
    the probabilities are cast to v's dtype before the PV product, as the
    reference's ``preferred_element_type=f32`` einsums do. Under autograd
    the backward recomputes each chunk's scores and probabilities
    (:class:`_Attention`). On DTensors each rank attends over its own rows
    or heads (:func:`_heads_local`).
    """
    if _is_dtensor(q):
        return _heads_local(_sdpa, q, k, v, rows, cols, window, causal)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:  # jnp.repeat's order: query head h reads KV head h // group
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    c = min(ATTN_CHUNK, t)
    pad = (-t) % c
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        cols = torch.cat([cols, torch.full((pad,), _COL_SENTINEL,
                                           dtype=cols.dtype,
                                           device=cols.device)])
    # In a layer its backward rematerializes (:func:`in_remat`), a single
    # chunk keeps its tensors only while that layer's backward runs: the
    # one chunk's worth a recompute of its own would rebuild there too (the
    # reference's compiled step folds the two recomputes into one as well).
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)) and (t + pad > c
                                                     or not _REMAT):
        out = _Attention.apply(q, k, v, rows, cols, window, causal, c)
    else:
        out = _online_softmax(q, k, v, rows, cols, window, causal, c)[2]
    return out.transpose(1, 2).reshape(b, s, hq * d).to(q.dtype)


def causal_window_mask(s: int, t: int, window: int, offset: int = 0,
                       device=None):
    """(1, s, t) boolean mask (kept for tests/reference paths)."""
    rows = torch.arange(s, device=device)[:, None] + offset
    cols = torch.arange(t, device=device)[None, :]
    mask = cols <= rows
    win_ok = (rows - cols < window) | (window < 0)
    return (mask & win_ok)[None]


def attention(x, p, cfg: ArchConfig, positions, window: int = -1,
              mrope_positions=None):
    """Full-sequence (train/prefill) attention. Returns (out, (k, v))."""
    q, k, v = _qkv(x, p, cfg)
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    idx = torch.arange(s, dtype=torch.int32, device=x.device)
    out = _sdpa(q, k, v, rows=idx, cols=idx, window=window, causal=True)
    return residual_branch(out @ p["wo"].to(x.dtype)), (k, v)


# When enabled (perf knob), decode with a *static* sliding window reads only
# the last `window` cache positions instead of scanning the full cache and
# masking — an O(T/window) memory-traffic reduction for windowed-attention
# archs at long context.
DECODE_WINDOW_SLICING = False

# Ring-buffer KV caches (perf knob): for uniform static-window archs the
# cache is ALLOCATED at window size and written at pos % window — O(window)
# memory and traffic regardless of context length.
RING_KV = False


def set_decode_window_slicing(enabled: bool):
    global DECODE_WINDOW_SLICING
    DECODE_WINDOW_SLICING = enabled


def set_ring_kv(enabled: bool):
    global RING_KV
    RING_KV = enabled


def ring_cache_len(cfg, max_len: int) -> int:
    """Allocation length for a KV cache: the static window when the ring
    knob is on and every layer shares one positive window."""
    if (RING_KV and cfg.window_pattern and cfg.window_pattern[0] > 0
            and all(w == cfg.window_pattern[0] for w in cfg.window_pattern)):
        return min(max_len, cfg.window_pattern[0])
    return max_len


def ring_positions(pos: int, t: int, device=None):
    """Absolute position stored in each ring slot (negative = unwritten)."""
    idx = torch.arange(t, dtype=torch.int32, device=device)
    return pos - torch.remainder(pos - idx, t)


def ring_store(k, cfg, max_len: int):
    """Lay prefill keys (B, S, H, D) out into the (possibly ring) cache
    (B, T_alloc, H, D): pad when it fits, else keep the last T_alloc
    positions at slots ``abs_pos % T_alloc``."""
    b, s, h, d = k.shape
    t_alloc = ring_cache_len(cfg, max_len)
    if t_alloc >= s:
        return pad(k, (0, 0, 0, 0, 0, t_alloc - s))
    tail = k[:, s - t_alloc:]
    slots = torch.as_tensor(np.arange(s - t_alloc, s) % t_alloc,
                            device=k.device)  # static permutation
    out = torch.zeros((b, t_alloc, h, d), dtype=k.dtype, device=k.device)
    out[:, slots] = tail
    return out


def attention_decode(x, p, cfg: ArchConfig, k_cache, v_cache, pos: int,
                     window: int = -1, mrope_positions=None,
                     static_window: int | None = None, ring: bool = False):
    """Single-token decode. x (B,1,D); caches (B,T,Hkv,D); pos int.

    The new key and value are written into ``k_cache``/``v_cache`` in place
    (views into the stacked cache, so no copy of it is made).
    ``ring``: the cache is a ring buffer of length T (= the static window);
    writes land at ``pos % T`` and key positions are reconstructed per slot.

    Returns (out, k_cache, v_cache)."""
    b, s, _ = x.shape
    pos = int(pos)
    q, k, v = _qkv(x, p, cfg)
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    t = k_cache.shape[1]
    # dynamic_update_slice's clamp: the write stays inside the cache
    write_pos = min(pos % t if ring else pos, t - s)
    k_cache[:, write_pos:write_pos + s] = k.to(k_cache.dtype)
    v_cache[:, write_pos:write_pos + s] = v.to(v_cache.dtype)
    rows = torch.full((s,), pos, dtype=torch.int32, device=x.device)
    k_use, v_use = k_cache, v_cache
    if ring:
        cols = ring_positions(pos, t, device=x.device)
        cols = torch.where(cols >= 0, cols, _COL_SENTINEL)
    elif (DECODE_WINDOW_SLICING and static_window is not None
            and 0 < static_window < t):
        w = static_window
        start = min(max(pos - w + 1, 0), t - w)
        k_use, v_use = k_cache[:, start:start + w], v_cache[:, start:start + w]
        cols = start + torch.arange(w, dtype=torch.int32, device=x.device)
    else:
        cols = torch.arange(t, dtype=torch.int32, device=x.device)
    out = _sdpa(q, k_use.to(x.dtype), v_use.to(x.dtype), rows=rows,
                cols=cols, window=window, causal=True)
    return out @ p["wo"].to(x.dtype), k_cache, v_cache


# ---------------------------------------------------------------------- mlp --

def init_mlp(d: int, f: int, act: str, generator: torch.Generator,
             stack: tuple[int, ...] = ()):
    p = {"w_up": _dense_init((*stack, d, f), generator),
         "w_down": _dense_init((*stack, f, d), generator)}
    if act == "silu":  # gated (SwiGLU)
        p["w_gate"] = _dense_init((*stack, d, f), generator)
    return p


def mlp(x, p, act: str):
    up = x @ p["w_up"].to(x.dtype)
    if act == "silu":
        gate = F.silu(x @ p["w_gate"].to(x.dtype))
        h = gate * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return residual_branch(h @ p["w_down"].to(x.dtype))


# ------------------------------------------------------------------ embedding --

def init_embedding(cfg: ArchConfig, generator: torch.Generator):
    # vocab padded to 128; padded logits are masked in unembed so the extra
    # rows are inert.
    p = {"embedding": _dense_init((cfg.padded_vocab, cfg.d_model), generator,
                                  scale=1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init((cfg.d_model, cfg.padded_vocab), generator)
    return p


def embed(tokens, p, cfg: ArchConfig, dtype):
    table = p["embedding"]
    if _is_dtensor(table):
        # Gathered whole first, an explicit redistribution: DTensor's
        # lookup in a vocab-sharded table leaves a masked partial whose
        # mask it misaligns when it also moves the tokens' batch, and
        # whose backward refuses a gradient that arrives as a pending sum.
        from torch.distributed.tensor import Replicate

        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    x = F.embedding(tokens.long(), table).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def unembed(x, p, cfg: ArchConfig):
    if cfg.tie_embeddings:
        w = p["embedding"].T
    else:
        w = p["lm_head"]
    logits = shard_act(x @ w.to(x.dtype), last_dim_model=True)
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~valid, -1e30)
        logits = shard_act(logits, last_dim_model=True)
    return logits


# --------------------------------------------------------------------- loss --

def _nll(logits, labels):
    """logits (B, S, V) f32 and labels (B, S) -> (B, S) negative log
    likelihoods. On a DTensor whose vocab a mesh dim shards it is
    Megatron's vocab-parallel cross-entropy (:func:`_vocab_parallel_nll`):
    DTensor's own logsumexp and gather all-gather the logits over the
    vocab, and the gather's backward makes a zero tensor of the logits'
    global shape on every rank."""
    v = logits.ndim - 1
    if _is_dtensor(logits) and any(q.is_shard(v) for q in logits.placements):
        return _vocab_parallel_nll(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    return logz - _sum_partial(
        torch.gather(logits, -1, labels.long()[..., None]))[..., 0]


def _vocab_parallel_nll(logits, labels):
    """:func:`_nll` on each rank's rows and vocab slice: the slices' max
    (an all-reduce of the max), then each slice's sum of exponentials and
    its labels' logits (zero for labels in other slices), summed over the
    slices (one all-reduce); the batch keeps its shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    v = logits.ndim - 1
    mesh = logits.device_mesh
    lp = [q if q.is_shard(0) or q.is_shard(v) else Replicate()
          for q in logits.placements]
    rows = [Shard(0) if q.is_shard(0) else Replicate() for q in lp]
    shape = tuple(logits.shape[:-1])
    if not _is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    local = _local(logits, mesh, lp)

    def partial(op):  # the vocab slices' mesh dims pending a reduction
        return [Partial(op) if q.is_shard(v) else r for q, r in zip(lp, rows)]

    m = _from_local(local.detach().amax(dim=-1), mesh, partial("max"),
                    shape).redistribute(mesh, rows).to_local()
    lab = labels.redistribute(mesh, rows).to_local().long()
    lab = lab - compute_local_shape_and_global_offset(
        logits.shape, mesh, lp)[1][v]
    inside = (lab >= 0) & (lab < local.shape[-1])
    gold = torch.gather(local, -1,
                        lab.clamp(0, local.shape[-1] - 1)[..., None])[..., 0]
    sums = torch.stack([torch.exp(local - m[..., None]).sum(dim=-1),
                        torch.where(inside, gold, torch.zeros_like(gold))],
                       dim=-1)
    sums = _local(_sum_partial(_from_local(sums, mesh, partial("sum"),
                                           (*shape, 2))), mesh, rows)
    return _from_local(m + torch.log(sums[..., 0]) - sums[..., 1], mesh,
                       rows, shape)


def lm_loss(logits, labels, mask=None):
    """Mean cross-entropy in f32. logits (B,S,V); labels (B,S) integer."""
    nll = _nll(logits.float(), labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
