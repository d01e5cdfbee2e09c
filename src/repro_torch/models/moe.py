"""Mixture-of-Experts transformer (Qwen2-MoE / Moonshot family), the JAX
package's ``models/moe.py`` ported.

Routing uses top-k softmax with capacity-bounded sort-free dispatch
(scatter into per-expert slot buffers), which keeps dispatch memory at
O(tokens·top_k) instead of the O(tokens·experts·capacity) einsum form.
Experts are padded up to a multiple of 16 when needed (60 -> 64 for
qwen2-moe); the padding experts are never routed to. A config that follows
a published layer may switch to a dropless path instead (``moe_dropless``:
each expert runs on exactly the tokens routed to it, none padded), to
unrenormalised top-k weights (``norm_topk_prob`` false) and to a shared
expert gated by ``sigmoid(x @ shared_gate)`` (``shared_expert_gate``).
DeepSeek-V3's layer (Moonlight-16B-A3B's) switches further: the experts
chosen on sigmoid scores plus a correction bias and weighted by the
unbiased ones times a scaling factor (``scoring_func``, ``topk_method``,
``routed_scaling_factor``), latent attention (``kv_lora_rank``,
``models/mla.py``) and leading layers with a dense MLP
(``first_k_dense_replace``: their parameters under ``dense_layers``).

The routing is the reference's decision for decision: ``lax.top_k``'s
lower-index-first order on ties, the stable sort that gives earlier tokens
capacity priority, the left-sided ``searchsorted`` and the dropped-token
slot ``e·cap``. The reference writes the backward of its dispatch and
combine by hand (a ``custom_vjp`` pair); here autograd derives the same
ones: the scatter's is a gather at the same slots (zero for a dropped
token, whose row is sliced off), the gather's a scatter-add.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_decode import kernel as decode_kernel
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models import transformer as T

# Rows a prefill runs at once, times their length: more rows are prefilled
# in groups into the one cache (Moonlight-16B-A3B's 16 prompts of 4096 in
# four; Qwen1.5-MoE-A2.7B's 4 in one).
PREFILL_TOKENS = 16384


def padded_experts(cfg: ArchConfig, ep: int = 16) -> int:
    """Experts held: padded up to a multiple of ``ep`` for the capacity
    path's expert-parallel slot buffer; the dropless path has none, and
    holds the published count."""
    e = cfg.n_experts
    if cfg.moe_dropless:
        return e
    return ((e + ep - 1) // ep) * ep if e % ep else e


def _init_attention(cfg: ArchConfig, generator, stack):
    if cfg.mla:
        return mla.init_attention(cfg, generator, stack)
    return L.init_attention(cfg, generator, stack)


def _init_dense_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """The leading layers whose MLP is dense (``first_k_dense_replace``)."""
    stack, d = (cfg.first_k_dense_replace,), cfg.d_model
    return {
        "ln1": L.init_norm(d, generator, stack),
        "attn": _init_attention(cfg, generator, stack),
        "ln2": L.init_norm(d, generator, stack),
        "mlp": L.init_mlp(d, cfg.dense_d_ff, "silu", generator, stack),
    }


def _init_layers(cfg: ArchConfig, generator: torch.Generator) -> dict:
    stack = (cfg.n_layers - cfg.first_k_dense_replace,)
    d, fe = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg)
    p = {
        "ln1": L.init_norm(d, generator, stack),
        "attn": _init_attention(cfg, generator, stack),
        "ln2": L.init_norm(d, generator, stack),
        "router": L._dense_init(stack + (d, e), generator),
        "experts": {
            "w_gate": L._dense_init(stack + (e, d, fe), generator),
            "w_up": L._dense_init(stack + (e, d, fe), generator),
            "w_down": L._dense_init(stack + (e, fe, d), generator),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(d, cfg.n_shared_experts * cfg.moe_d_ff,
                                 "silu", generator, stack)
    if cfg.shared_expert_gate:
        p["shared_gate"] = L._dense_init(stack + (d, 1), generator)
    if cfg.topk_method == "noaux_tc":  # the correction bias, as trained: 0
        p["router_bias"] = torch.zeros(stack + (e,), dtype=torch.float32,
                                       device=generator.device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> T.Model:
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device``."""
    tree = {
        **L.init_embedding(cfg, generator),
        "layers": _init_layers(cfg, generator),
        "final_norm": L.init_norm(cfg.d_model, generator),
    }
    if cfg.first_k_dense_replace:
        tree["dense_layers"] = _init_dense_layers(cfg, generator)
    return T.Model(cfg, tree, forward).to(device)


def router_logits(x, router, cfg: ArchConfig):
    """The router's f32 logits of ``x``: the product in x's dtype, or, for
    sigmoid scores, in f32, as DeepSeek-V3's published gate computes
    them."""
    if cfg.scoring_func == "sigmoid":
        return x.float() @ router.float()
    return (x @ router.to(x.dtype)).float()


def _bias(lp, cfg: ArchConfig) -> tuple:
    """A layer's correction bias as :func:`top_k`'s last argument: ``(bias,)``
    where the config chooses with one, else ``()``."""
    return (lp["router_bias"],) if cfg.topk_method == "noaux_tc" else ()


def route(x, router, cfg: ArchConfig):
    """The routing decision of ``x`` (B, S, D): ``(sel, gates, slot,
    cap)``. ``sel`` (B, S, k) holds each token's experts, best first (a tie
    goes to the lower index, as ``lax.top_k``'s); ``gates`` their softmax
    weights in x's dtype; ``slot`` (B, S·k) each assignment's row of the
    (E·cap) slot buffer, ``E·cap`` where capacity dropped it."""
    logits = (x @ router.to(x.dtype)).float()
    # each row's decision is its own (capacity counts along S): on a
    # DTensor, each rank routes its rows
    return L.by_rows(_route_rows, logits, x.dtype, cfg)


def top_k(logits, cfg: ArchConfig, bias=None):
    """Each token's ``cfg.top_k`` experts, best first (a tie goes to the
    lower index, as ``lax.top_k``'s), and their f32 weights: the softmax of
    the top-k logits alone (``norm_topk_prob``), or the softmax over every
    expert's logit, kept unrenormalised. ``logits`` (..., E) f32.

    With ``scoring_func="sigmoid"`` (DeepSeek-V3) each expert's score is
    ``sigmoid(logit)``; the experts are chosen on score + ``bias`` (the
    correction bias, or None), and weighted by their unbiased scores, with
    ``norm_topk_prob`` divided by their sum + 1e-20, times
    ``routed_scaling_factor``."""
    e = logits.shape[-1]
    pad_mask = None
    if e != cfg.n_experts:  # padding experts are never routed to
        pad_mask = torch.arange(e, device=logits.device) >= cfg.n_experts
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores if bias is None else scores + bias.float()
        if pad_mask is not None:
            choice = choice.masked_fill(pad_mask, -1e30)
        sel = torch.sort(choice, dim=-1, descending=True,
                         stable=True)[1][..., :cfg.top_k]
        gates = torch.gather(scores, -1, sel)
        if cfg.norm_topk_prob:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
        return sel, gates * cfg.routed_scaling_factor
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask, -1e30)
    # a stable descending sort keeps the lower index first among equals
    gate_vals, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_vals, sel = gate_vals[..., :cfg.top_k], sel[..., :cfg.top_k]
    if cfg.norm_topk_prob:
        return sel, torch.softmax(gate_vals, dim=-1)
    return sel, torch.gather(torch.softmax(logits, dim=-1), -1, sel)


def _route_rows(logits, dtype, cfg: ArchConfig):
    b, s, _ = logits.shape
    e = padded_experts(cfg)
    k = cfg.top_k
    sel, gates = top_k(logits, cfg)                           # (B, S, k)
    gates = gates.to(dtype)

    cap = max(8, int(math.ceil(s * k / e * cfg.capacity_factor)))
    flat_sel = sel.reshape(b, s * k)                          # (B, S*k)
    # Sort-based position-in-expert: the sort is stable, so earlier tokens
    # keep capacity priority.
    order = torch.argsort(flat_sel, dim=1, stable=True)
    sorted_e = torch.gather(flat_sel, 1, order)
    experts = torch.arange(e, device=logits.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)            # (B, E), left
    pos_sorted = (torch.arange(s * k, device=logits.device)[None]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.zeros_like(flat_sel).scatter_(1, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_sel * cap + pos,
                       torch.full_like(flat_sel, e * cap))
    return sel, gates, slot, cap


def _dispatch(x_rep, slot, n_slots: int):
    """(B, Sk, D) tokens -> (B, n_slots, D) expert slot buffer: a scatter
    into ``n_slots + 1`` rows, the last catching every dropped token. On
    DTensors each rank scatters its own rows (``by_rows``): no rank holds
    another's rows of the buffer."""
    return L.shard_act(L.by_rows(_scatter_rows, x_rep, slot, n_slots))


def _scatter_rows(x_rep, slot, n_slots: int):
    b, _, d = x_rep.shape
    buf = x_rep.new_zeros((b, n_slots + 1, d))
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), x_rep)
    return buf[:, :n_slots]


def _combine(out_flat, slot, n_slots: int):
    """(B, n_slots, D) expert outputs -> (B, Sk, D) per-token outputs, zero
    for a dropped token; on DTensors each rank gathers its own rows."""
    return L.shard_act(L.by_rows(_gather_rows, out_flat, slot, n_slots))


def _gather_rows(out_flat, slot, n_slots: int):
    keep = (slot < n_slots)[..., None]
    idx = torch.clamp(slot, max=n_slots - 1)[..., None]
    g = torch.gather(out_flat, 1, idx.expand(-1, -1, out_flat.shape[-1]))
    return torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))


def _expert_mlp(expert_in, we: dict):
    """Each expert's gated MLP on its slots: (B, E, C, D) -> (B, E, C, D)."""
    gate_h = F.silu(torch.einsum("becd,edf->becf", expert_in, we["w_gate"]))
    up_h = torch.einsum("becd,edf->becf", expert_in, we["w_up"])
    return torch.einsum("becf,efd->becd", gate_h * up_h, we["w_down"])


def _capacity_experts(x, lp, cfg: ArchConfig):
    """The routed experts' part of the layer through capacity-bounded slot
    buffers: every held expert runs on its ``cap`` slots, and assignments
    past an expert's capacity are dropped. Dispatch is grouped by batch
    row: the capacity count runs along S within each row."""
    b, s, d = x.shape
    e = padded_experts(cfg)
    k = cfg.top_k
    with tracing.span("moe.route"):
        _, gates, slot, cap = route(x, lp["router"], cfg)
    if tracing.recording():  # a count that waits for the card
        tracing.count("moe.dropped", int((slot == e * cap).sum()))

    with tracing.span("moe.experts"):
        x_rep = L.shard_act(x.repeat_interleave(k, dim=1))    # (B, S*k, D)
        expert_in = L.shard_expert(
            _dispatch(x_rep, slot, e * cap).reshape(b, e, cap, d))

        we = {k: w.to(x.dtype) for k, w in lp["experts"].items()}
        out = L.experts_local(_expert_mlp, expert_in, we)

        out_flat = L.shard_expert(out).reshape(b, e * cap, d)
        gathered = _combine(out_flat, slot, e * cap)
        y = (gathered.reshape(b, s, k, d) * gates[..., None]).sum(dim=2)
    tracing.count("moe.experts_read", e)
    return y


def _dropless_experts(x, lp, cfg: ArchConfig, record=None):
    """The routed experts' part of the layer with no capacity: the B·S·k
    assignments sorted by expert, and each expert's gate, up and down
    projections run on exactly its rows by one grouped matmul each
    (``torch._grouped_mm``: an expert that no token chose is an empty
    group, whose weights are never read); each token's k results summed
    with their weights in f32, in the token's own order (no atomics). The
    expert counts stay on the card: the host never waits here, except to
    count the experts read while spans are recorded. ``record``: where to
    write each row's experts (:func:`moe_ffn`)."""
    b, s, d = x.shape
    k = cfg.top_k
    with tracing.span("moe.route"):
        logits = router_logits(x, lp["router"], cfg)
        sel, gates = top_k(logits, cfg, *_bias(lp, cfg))
        if record is not None:
            record.copy_(sel.reshape(record.shape))
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        # each expert's last row + 1 in the sorted order (``bincount``
        # would wait for the card to size its output)
        ends = torch.searchsorted(
            flat[order], torch.arange(cfg.n_experts, device=flat.device),
            right=True).to(torch.int32)
    if tracing.recording():  # a count that waits for the card
        read = torch.diff(ends, prepend=ends.new_zeros(1)) > 0
        tracing.count("moe.experts_read", int(read.sum()))
    with tracing.span("moe.experts"):
        rows = x.reshape(b * s, d)[order // k]     # (B*S*k, D) by expert
        we = {name: w.to(x.dtype) for name, w in lp["experts"].items()}
        act = F.silu(torch._grouped_mm(rows, we["w_gate"], offs=ends)) \
            * torch._grouped_mm(rows, we["w_up"], offs=ends)
        out = torch.empty_like(rows)
        out[order] = torch._grouped_mm(act, we["w_down"], offs=ends)
        y = (out.reshape(b, s, k, d).float() * gates[..., None]).sum(dim=2)
    tracing.count("moe.dropped", 0)
    return y.to(x.dtype)


def _decode_kernel_applies(x, lp, cfg: ArchConfig) -> bool:
    """Whether the layer of rows ``x`` (B, S, D) takes the decode-step MoE
    kernel (``kernels/moe_decode``): a dropless config, CUDA tensors that
    are not DTensors, no gradient to keep, at most ``MAX_ROWS`` rows (a
    decode step's, not a prefill's), x and every weight in bf16, and widths,
    experts and top-k the kernel takes. Elsewhere the grouped path runs
    (:func:`_dropless_experts` and the shared expert's ``L.mlp``) or the
    capacity path. Where the gate is open, the wrapper's own checks
    (strides, alignment) raise rather than change path."""
    b, s, d = x.shape
    if not cfg.moe_dropless or x.device.type != "cuda" \
            or b * s > decode_kernel.MAX_ROWS:
        return False
    weights = [x, lp["router"], *lp["experts"].values()]
    if cfg.n_shared_experts:
        weights += lp["shared"].values()
    if cfg.shared_expert_gate:
        weights.append(lp["shared_gate"])
    weights += _bias(lp, cfg)
    if any(L._is_dtensor(w) for w in weights):
        return False
    if torch.is_grad_enabled() and any(w.requires_grad for w in weights):
        return False
    return (all(w.dtype == torch.bfloat16 for w in weights)
            and decode_kernel.takes(d, lp["experts"]["w_gate"].shape[-1],
                                    lp["router"].shape[-1], cfg.top_k))


def _decode_kernel_ffn(x, lp, cfg: ArchConfig, record=None):
    """The layer through the decode-step MoE kernel, in span ``moe.ffn``.
    The experts read are counted from the kernel's per-expert row counts, a
    count that waits for the card, so only while spans are recorded, and
    after the span: the copy that brings them to the host is no work of the
    layer's."""
    b, s, d = x.shape
    with tracing.span("moe.ffn"):
        tracing.count("moe.assignments", b * s * cfg.top_k)
        y, routing = decode_kernel.moe_decode(
            x.reshape(b * s, d), lp["router"], lp["experts"],
            lp["shared"] if cfg.n_shared_experts else None,
            lp["shared_gate"] if cfg.shared_expert_gate else None,
            cfg.top_k, cfg.norm_topk_prob, scoring=cfg.scoring_func,
            bias=next(iter(_bias(lp, cfg)), None),
            scale=cfg.routed_scaling_factor, sel=record)
    if tracing.recording():
        tracing.count("moe.experts_read",
                      int((routing.counts.cpu() > 0).sum()))
    tracing.count("moe.dropped", 0)
    return y.reshape(b, s, d)


def moe_ffn(x, lp, cfg: ArchConfig, record=None):
    """x (B, S, D) -> (B, S, D): top-k routed experts + shared experts, the
    shared ones scaled by ``sigmoid(x @ shared_gate)`` where the config
    gates them (``shared_expert_gate``). A decode step's few rows on a card
    take one kernel for all of it (:func:`_decode_kernel_applies`).
    ``record`` (B * S, k) int32, on a dropless layer: each row's experts,
    best first, written there (the decode state's ``experts``)."""
    if _decode_kernel_applies(x, lp, cfg):
        return _decode_kernel_ffn(x, lp, cfg, record)
    b, s, _ = x.shape
    with tracing.span("moe.ffn"):
        tracing.count("moe.assignments", b * s * cfg.top_k)
        if cfg.moe_dropless:
            y = _dropless_experts(x, lp, cfg, record)
        else:
            y = _capacity_experts(x, lp, cfg)
        if cfg.n_shared_experts:
            with tracing.span("moe.shared"):
                shared = L.mlp(x, lp["shared"], "silu")
                if cfg.shared_expert_gate:
                    shared = torch.sigmoid(
                        x @ lp["shared_gate"].to(x.dtype)) * shared
                y = y + shared
        return L.residual_branch(y)


def _attention(h, lp, window: int, cfg: ArchConfig, positions):
    """A layer's full-sequence attention: (out, the cache's part)."""
    if cfg.mla:
        return mla.attention(h, lp["attn"], cfg, positions)
    return L.attention(h, lp["attn"], cfg, positions, window)


def _ffn(h, lp, cfg: ArchConfig, dense: bool, record=None):
    """A layer's MLP: dense (span ``mlp.dense``) or the MoE layer."""
    if dense:
        with tracing.span("mlp.dense"):
            return L.mlp(h, lp["mlp"], "silu")
    return moe_ffn(h, lp, cfg, record)


def _block(x, lp, window: int, cfg: ArchConfig, positions,
           dense: bool = False):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, _ = _attention(h, lp, window, cfg, positions)
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return L.shard_act(x + _ffn(h, lp, cfg, dense), seq_model=True)


def _positions(tokens, x):
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def layer_stack(params, cfg: ArchConfig) -> list[tuple[dict, bool]]:
    """Every layer's parameters in order (:func:`T.unbind_layers`), each
    with whether its MLP is dense: the ``first_k_dense_replace`` layers of
    ``dense_layers``, then the MoE layers."""
    dense = (T.unbind_layers(params["dense_layers"])
             if cfg.first_k_dense_replace else [])
    return [(lp, True) for lp in dense] + [
        (lp, False) for lp in T.unbind_layers(params["layers"])]


def forward(params: T.Model, tokens, cfg: ArchConfig, *,
            remat: str = "full"):
    """tokens (B, S) -> logits (B, S, V). ``remat``: each layer's policy
    under autograd (:func:`~repro_torch.models.transformer.remat_layer`)."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    positions = _positions(tokens, x)
    block = T.remat_layer(_block, remat)
    for i, (lp, dense) in enumerate(layer_stack(params, cfg)):
        x = block(x, lp, cfg.window_for_layer(i), cfg, positions, dense)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params, cfg)


def _expert_record(cfg: ArchConfig, batch: int, device) -> dict:
    """A dropless config's decode state keeps the experts each MoE layer
    chose for each row at the last step, best first: ``experts`` (MoE
    layers, B, k) int32, written in place by every step (a captured step
    too), which a server reads to see its experts' load."""
    if not cfg.moe_dropless:
        return {}
    shape = (cfg.n_layers - cfg.first_k_dense_replace, batch, cfg.top_k)
    return {"experts": torch.zeros(shape, dtype=torch.int32, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    if cfg.mla:
        cache = mla.init_cache(cfg, batch, max_len,
                               dtype or T.DTYPES[cfg.dtype], device)
    else:
        cache = T.init_cache(cfg, batch, max_len, dtype, device)
    return {**cache, **_expert_record(cfg, batch, device)}


@torch.no_grad()
def decode_step(params: T.Model, cache, tokens, pos: int, cfg: ArchConfig):
    """One-token decode; the stacked cache is written in place, and, for a
    dropless config, the experts each MoE layer chose (``experts``). Each
    residual add is taken with the norm after it (``L.add_rms_norm``: one
    launch a pair on the card)."""
    x = L.embed(tokens, params, cfg, T.DTYPES[cfg.dtype])
    records = cache.get("experts")
    k = cfg.first_k_dense_replace
    branch = None  # the last MLP's output, added where the next norm reads
    for i, (lp, dense) in enumerate(layer_stack(params, cfg)):
        x, h = L.add_rms_norm(x, branch, lp["ln1"], cfg.norm_eps)
        if cfg.mla:
            attn_out = mla.attention_decode(h, lp["attn"], cfg,
                                            cache["latent"][i], pos)
        else:
            attn_out, _, _ = L.attention_decode(
                h, lp["attn"], cfg, cache["k"][i], cache["v"][i], pos,
                cfg.window_for_layer(i))
        x, h = L.add_rms_norm(x, attn_out, lp["ln2"], cfg.norm_eps)
        record = None if dense or records is None else records[i - k]
        branch = _ffn(h, lp, cfg, dense, record)
    _, h = L.add_rms_norm(x, branch, params["final_norm"], cfg.norm_eps)
    return L.unembed(h, params, cfg)[:, 0], cache


@torch.no_grad()
def prefill(params: T.Model, tokens, cfg: ArchConfig, max_len: int):
    """Forward + cache (padded to ``max_len``). Returns (logits, cache):
    the logits of every position, or, where the rows are more than
    :data:`PREFILL_TOKENS` tokens and are prefilled in groups, of the last
    position alone, (B, 1, V)."""
    b, s = tokens.shape
    rows = max(1, PREFILL_TOKENS // s)
    if b <= rows:
        return _prefill(params, tokens, cfg, max_len)
    last, cache = [], None
    for r0 in range(0, b, rows):
        logits, part = _prefill(params, tokens[r0:r0 + rows], cfg, max_len,
                                last_only=True)
        last.append(logits)
        if cache is None:
            cache = {name: t.new_zeros((t.shape[0], b, *t.shape[2:]))
                     for name, t in part.items()}
        for name, t in part.items():
            cache[name][:, r0:r0 + rows] = t
        del part
    return torch.cat(last), cache


def _prefill(params: T.Model, tokens, cfg: ArchConfig, max_len: int,
             last_only: bool = False):
    dtype = T.DTYPES[cfg.dtype]
    x = L.embed(tokens, params, cfg, dtype)
    positions = _positions(tokens, x)
    b, s = tokens.shape
    pad = max_len - s
    ks, vs = [], []
    if cfg.mla:
        cache = mla.init_cache(cfg, b, max_len, dtype, x.device)
    for i, (lp, dense) in enumerate(layer_stack(params, cfg)):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, kv = _attention(h, lp, cfg.window_for_layer(i), cfg,
                                  positions)
        x = x + attn_out
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(h, lp, cfg, dense)
        if cfg.mla:
            cache["latent"][i, :, :s] = kv
        else:
            kk, vv = kv
            ks.append(L.pad(kk.to(dtype), (0, 0, 0, 0, 0, pad)))
            vs.append(L.pad(vv.to(dtype), (0, 0, 0, 0, 0, pad)))
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not cfg.mla:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    cache.update(_expert_record(cfg, b, x.device))
    return L.unembed(x, params, cfg), cache
