"""One greedy decode step of Moonlight-16B-A3B at batch B, dims (B, prompt,
max_len): each row's logits at the step's position, given every token the
row has been fed. Its input rule, plain reference, control, comparison,
bytes and operations.

Plain PyTorch, importing nothing of the program: the model is written again
from its published description (the Hugging Face ``config.json`` of
moonshotai/Moonlight-16B-A3B, ``model_type`` deepseek_v3, and the
DeepSeek-V3 modelling code it names): RMSNorm; latent attention with no
query compression (q of 16 heads x (128 nope + 64 rope); ``x @ wkv_a`` =
c_kv 512 ‖ k_pe 64, c_kv RMS-normed with ε 1e-6, the published
``DeepseekV3RMSNorm``'s default; ``c_kv @ wkv_b`` = each head's k_nope 128
‖ v 128), RoPE of θ 50000 on q_pe and the shared k_pe in the checkpoint's
interleaved pair order (de-interleaved, then rotate-half, as published),
causal softmax at 1/sqrt(192); RMSNorm; layer 0 a SwiGLU of 11264, the 26
others a MoE block: sigmoid scores of the router's f32 logits, the top-6 of
score + correction bias (``noaux_tc``; one group), weighted by the chosen
unbiased scores over their sum + 1e-20 times 2.446, each routed token
through its experts' SwiGLU with no capacity, plus two ungated shared
experts as one SwiGLU of 2816. The reference runs the whole sequence again
in float32 with TF32 off, in its decompressed form: no cache, no latent
absorption, no batching of rows' positions. Departures, none of which
changes the mathematics: the layers' weights are upcast to f32 one layer at
a time, attention runs a row and a block of queries at a time, an expert
runs on the rows that chose it (the published block's loop over experts)
and the dense products a block of token rows at a time, so that it fits on
the card beside the program's weights; RoPE's angles are computed in
float64.

The routing of the checked position. With every hidden state rounded to
bf16 (the configuration's precision), about one row in two has an expert
change somewhere in its 26 MoE layers at the checked position: the 6th and
7th choices lie closer than bf16 resolves, and a changed expert moves that
row's logits by up to all they are (routed experts carry 2.446 of weight
beside the shared experts' one), through every layer after it. So the
program hands over its choices at the checked position (the decode state's
``experts``), and the reference takes them there, weighting them by its own
scores; every other position routes by the reference's own choices
(attention averages their rows). The choices themselves are held to the
reference's own top-k in score + bias: where more than
:data:`MAX_DISAGREE` of them lie outside it, the reference's logits are
NaN, which :func:`error` reads as infinite (a rule that ignored the
correction bias would disagree on about the share of choices the bias
moves, ~23 % at the cell's sizes).

The weights are a nested dict, each projection stored (in, out) so that
``y = x @ w``: ``embedding`` (V, D), ``lm_head`` (D, V), ``final_norm``
(D,); under ``dense_layers`` (the first layer, stacked on a leading axis of
1) and ``layers`` (the 26 MoE layers): ``ln1``, ``ln2`` (L, D); ``attn``:
``wq`` (L, D, H*192), ``wkv_a`` (L, D, 576), ``kv_norm`` (L, 512),
``wkv_b`` (L, 512, H*256), ``wo`` (L, H*128, D); under ``dense_layers``
``mlp``: ``w_gate``, ``w_up`` (1, D, 11264), ``w_down`` (1, 11264, D);
under ``layers`` ``router`` (L, D, E), ``router_bias`` (L, E),
``experts``: ``w_gate``, ``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D),
``shared``: ``w_gate``, ``w_up`` (L, D, 2F), ``w_down`` (L, 2F, D).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# The largest ||got - ref||_2 / ||ref||_2 over the checked rows' logits.
# The program (bf16 weights, activations and latent cache, the checked
# position routed as it routed it) read 0.0317-0.0352 on 5 seeds at the
# cell's sizes, the float8 control 0.3669-0.3693 on 3 (PERF.md section 2):
# the limit lies 2.8 times above the one and 3.7 times below the other.
NUMBER, LIMIT, COMBINE = "decode_logit_rel_err", 0.1, "max"
# The largest share of the program's choices at the checked position that
# may lie outside the reference's own top-k. The program's lay outside for
# 1.36-2.12 % of them (10 answers, 5 seeds); the correction bias moves
# 22.7 % of the choices from the unbiased top-6 at the cell's sizes, on
# which a rule without it would disagree (PERF.md section 2): the limit lies
# 4.7 times above the one and 2.3 times below the other.
MAX_DISAGREE = 0.1

# The published config.json's values (the catalog's row).
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "max_position_embeddings": 8192,
    "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_theta": 50000,
    "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840,
}
BYTES = {"bfloat16": 2, "float32": 4}
KV_NORM_EPS = 1e-6
ROWS = 16384  # token rows a dense product takes at once


# ---------------------------------------------------------------- shapes --

def _attn_shapes(model: dict, n: int) -> dict:
    d, h = model["hidden_size"], model["num_attention_heads"]
    r, rope = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, vd = model["qk_nope_head_dim"], model["v_head_dim"]
    return {"wq": (n, d, h * (nope + rope)), "wkv_a": (n, d, r + rope),
            "kv_norm": (n, r), "wkv_b": (n, r, h * (nope + vd)),
            "wo": (n, h * vd, d)}


def shapes(model: dict) -> dict:
    """Each weight's shape, under the names the module docstring gives."""
    d, v = model["hidden_size"], model["vocab_size"]
    k = model["first_k_dense_replace"]
    n = model["num_hidden_layers"] - k
    e, f = model["n_routed_experts"], model["moe_intermediate_size"]
    s = model["n_shared_experts"] * f
    fd = model["intermediate_size"]
    return {
        "embedding": (v, d), "lm_head": (d, v), "final_norm": (d,),
        "dense_layers": {
            "ln1": (k, d), "ln2": (k, d), "attn": _attn_shapes(model, k),
            "mlp": {"w_gate": (k, d, fd), "w_up": (k, d, fd),
                    "w_down": (k, fd, d)},
        },
        "layers": {
            "ln1": (n, d), "ln2": (n, d), "attn": _attn_shapes(model, n),
            "router": (n, d, e), "router_bias": (n, e),
            "experts": {"w_gate": (n, e, d, f), "w_up": (n, e, d, f),
                        "w_down": (n, e, f, d)},
            "shared": {"w_gate": (n, d, s), "w_up": (n, d, s),
                       "w_down": (n, s, d)},
        },
    }


# ------------------------------------------------------------ input rule --

def _draw(shape, std: float, dtype, gen, device):
    """A normal tensor of ``std`` in ``dtype``, drawn in float32 one slice
    of the leading axis at a time (a stacked expert tensor is never held
    in float32 whole)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if len(shape) > 2 else [out]):
        part.copy_(torch.randn(part.shape, generator=gen, device=device)
                   .mul_(std))
    return out


def weights(model: dict, dtype, assumed: dict, gen, device) -> dict:
    """Every weight at ``model``'s shapes in ``dtype``: the projections,
    router, embedding and head normal with a spread of ``init_std``, the
    correction bias of ``bias_std``, the norms ones."""
    def draw(name, shape):
        if name.startswith("ln") or name in ("final_norm", "kv_norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        std = assumed["bias_std"] if name == "router_bias" \
            else assumed["init_std"]
        return _draw(shape, std, dtype, gen, device)

    def tree(node):
        return {name: tree(v) if isinstance(v, dict) else draw(name, v)
                for name, v in node.items()}
    return tree(shapes(model))


def inputs(dims, dtype: str, assumed: dict, gen, device: str,
           model: dict = PUBLISHED) -> tuple:
    """(weights in ``dtype``, prompt ids (B, prompt) uniform over the
    vocabulary), drawn from ``gen`` on ``device`` in that order."""
    b, prompt, _ = dims
    w = weights(model, getattr(torch, dtype), assumed, gen, device)
    ids = torch.randint(0, model["vocab_size"], (b, prompt), generator=gen,
                        device=device)
    return w, ids


# ------------------------------------------------------------- reference --

def _to_float8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor, its
    largest magnitude at the format's largest, 448."""
    scale = 448.0 / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _matmul(lowp: bool):
    if not lowp:
        return torch.matmul
    return lambda a, b: torch.matmul(_to_float8(a), _to_float8(b))


def _rms(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta: float):
    """The published RoPE of x (B, L, H, d) at positions 0 .. L-1: each
    head's pairs (2i, 2i + 1) de-interleaved into halves, then
    rotate-half."""
    b, n, h, d = x.shape
    x = x.view(b, n, h, d // 2, 2).transpose(-1, -2).reshape(b, n, h, d)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _by_rows(fn, t):
    """``fn`` of the token rows ``t`` (T, ...) a block of :data:`ROWS` at a
    time."""
    return torch.cat([fn(t[i:i + ROWS]) for i in range(0, t.shape[0], ROWS)])


def _causal(q, k, v, mm, block: int = 1024):
    """Causal softmax attention of q, k (B, L, H, dk) and v (B, L, H, dv),
    scaled by 1/sqrt(dk); a row and ``block`` queries at a time. Returns
    (B, L, H * dv)."""
    b, n, h, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty(b, n, h * dv, dtype=q.dtype, device=q.device)
    for r in range(b):
        kr, vr = k[r].transpose(0, 1), v[r].transpose(0, 1)      # (H, L, d)
        for i in range(0, n, block):
            qi = q[r, i:i + block].transpose(0, 1)                # (H, c, dk)
            c = qi.shape[1]
            scores = mm(qi, kr[:, :i + c].transpose(1, 2)) / math.sqrt(dk)
            rows = torch.arange(i, i + c, device=q.device)[:, None]
            cols = torch.arange(i + c, device=q.device)[None, :]
            scores = scores.masked_fill(cols > rows, float("-inf"))
            o = mm(torch.softmax(scores, dim=-1), vr[:, :i + c])  # (H, c, dv)
            out[r, i:i + c] = o.transpose(0, 1).reshape(c, h * dv)
    return out


def _attention(t, a, model: dict, mm):
    b, n, _ = t.shape
    h, r = model["num_attention_heads"], model["kv_lora_rank"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    theta = model["rope_theta"]
    q = mm(t, a["wq"]).view(b, n, h, nope + rope)
    kv = mm(t, a["wkv_a"])
    c_kv = _rms(kv[..., :r], a["kv_norm"], KV_NORM_EPS)
    k_pe = _rope(kv[..., None, r:], theta).expand(b, n, h, rope)
    kvb = mm(c_kv, a["wkv_b"]).view(b, n, h, -1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([kvb[..., :nope], k_pe], dim=-1)
    return mm(_causal(q, k, kvb[..., nope:], mm), a["wo"])


def _swiglu(t, m: dict, mm):
    return mm(F.silu(mm(t, m["w_gate"])) * mm(t, m["w_up"]), m["w_down"])


def _take(chosen, given, rows):
    """The given choices (B, k) into ``chosen`` at token ``rows`` (B,).
    Returns how many of them lie outside the rows' own choices there, and
    whether a row names an expert twice."""
    given = given.long()
    outside = ~(given[:, :, None] == chosen[rows][:, None, :]).any(-1)
    twice = (given.sort(1).values.diff(dim=1) == 0).any(1)
    chosen[rows] = given
    return int(outside.sum()), bool(twice.any())


def _moe(t, lw: dict, model: dict, mm, forced=None):
    """The MoE block of token rows ``t``; ``forced``: (token rows, the
    program's choices there, a list :func:`_take`'s findings go to), or
    None."""
    scores = torch.sigmoid(mm(t, lw["router"]))                  # (T, E)
    _, chosen = torch.topk(scores + lw["router_bias"],
                           model["num_experts_per_tok"], dim=-1)
    if forced is not None:
        rows, given, out = forced
        out.append(_take(chosen, given, rows))
    weight = scores.gather(1, chosen)
    if model["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * model["routed_scaling_factor"]
    y = _by_rows(lambda rows: _swiglu(rows, lw["shared"], mm), t)
    ex = lw["experts"]
    for e in range(model["n_routed_experts"]):
        tok, slot = torch.where(chosen == e)
        if tok.numel():
            out = _swiglu(t[tok], {k: w[e] for k, w in ex.items()}, mm)
            y.index_add_(0, tok, out * weight[tok, slot, None])
    return y


def _layer(x, lw: dict, model: dict, mm, dense: bool, forced=None):
    b, n, d = x.shape
    eps = model["rms_norm_eps"]
    x = x + _attention(_rms(x, lw["ln1"], eps), lw["attn"], model, mm)
    t = _rms(x, lw["ln2"], eps).reshape(b * n, d)
    if dense:
        y = _by_rows(lambda rows: _swiglu(rows, lw["mlp"], mm), t)
    else:
        y = _moe(t, lw, model, mm, forced)
    return x + y.view(b, n, d)


def _layer_weights(tree: dict, i: int, device) -> dict:
    """Layer ``i``'s weights upcast to float32."""
    return {name: _layer_weights(v, i, device) if isinstance(v, dict)
            else v[i].to(device=device, dtype=torch.float32)
            for name, v in tree.items()}


def logits_at_last(model: dict, w: dict, tokens, lowp: bool = False,
                   experts=None, found: list | None = None):
    """The logits (B, V) at the last position of ``tokens`` (B, L): the
    forward pass over the whole of each row, in float32 (TF32 off), or
    with every matmul's inputs rounded to float8 e4m3 (``lowp``).
    ``experts`` (MoE layers, B, k): the program's choices at the last
    position, taken there (the module docstring). ``found`` gets, for each
    MoE layer, how many of them lay outside the reference's own and
    whether a row named an expert twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _matmul(lowp)
    device = w["embedding"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, n = tokens.shape
    k = model["first_k_dense_replace"]
    last = torch.arange(b, device=device) * n + n - 1
    taken: list = []
    with torch.no_grad():
        x = w["embedding"][tokens].to(torch.float32)
        for i in range(model["num_hidden_layers"]):
            dense = i < k
            lw = _layer_weights(w["dense_layers"] if dense else w["layers"],
                                i if dense else i - k, device)
            forced = None
            if experts is not None and not dense:
                forced = (last, experts[i - k].to(device), taken)
            x = _layer(x, lw, model, mm, dense, forced)
        x = _rms(x[:, -1], w["final_norm"].float(), model["rms_norm_eps"])
        logits = mm(x, w["lm_head"].float())
    if found is not None:
        found.extend(taken)
    return logits


def disagree(taken: list, experts) -> float:
    """The share of the program's choices outside the reference's own, from
    :func:`logits_at_last`'s ``found``; 1 where a row named an expert
    twice."""
    if any(twice for _, twice in taken):
        return 1.0
    return sum(n for n, _ in taken) / experts.numel()


def reference(args, assumed: dict) -> torch.Tensor:
    """The reference's logits; NaN where the program's choices disagree
    with its own beyond :data:`MAX_DISAGREE`."""
    model, w, tokens, experts = args
    taken: list = []
    logits = logits_at_last(model, w, tokens, experts=experts, found=taken)
    if disagree(taken, experts) > MAX_DISAGREE:
        logits[:] = float("nan")
    return logits


def control(args, assumed: dict) -> torch.Tensor:
    """The reference with float8 e4m3 at every matmul input: the precision
    below the configuration's bfloat16, taking the program's choices at
    the checked position as they are."""
    model, w, tokens, experts = args
    return logits_at_last(model, w, tokens, lowp=True, experts=experts)


def error(got, want, args) -> float:
    """The largest ||got - want||_2 / ||want||_2 over the rows; infinite
    where the reference refused the program's choices (its NaN logits)."""
    if got.shape != want.shape or torch.isnan(want).any():
        return float("inf")
    got = got.to(device=want.device, dtype=torch.float32)
    rel = torch.linalg.vector_norm(got - want, dim=-1) \
        / torch.linalg.vector_norm(want, dim=-1)
    return float(rel.max())


# ----------------------------------------------------- bytes, operations --

def distinct_experts(b: int, model: dict = PUBLISHED) -> float:
    """Experts a MoE layer reads at one step of ``b`` rows under uniform
    routing: each expert is left out by a row with probability 1 - k/E."""
    e, k = model["n_routed_experts"], model["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** b)


def expert_bytes(dtype: str, model: dict = PUBLISHED) -> float:
    """One routed expert's gate, up and down weights."""
    return 3 * model["hidden_size"] * model["moe_intermediate_size"] \
        * BYTES[dtype]


def moe_weight_bytes(dtype: str, model: dict = PUBLISHED) -> float:
    """A MoE layer's weights besides its routed experts: the two ungated
    shared experts, the router and the correction bias."""
    d, e = model["hidden_size"], model["n_routed_experts"]
    s = model["n_shared_experts"] * model["moe_intermediate_size"]
    return (3 * d * s + d * e + e) * BYTES[dtype]


def moe_fixed_bytes(b: int, dtype: str, model: dict = PUBLISHED) -> float:
    """What a MoE layer moves at a step of ``b`` rows besides its routed
    experts: :func:`moe_weight_bytes` read once, and the rows'
    activations read in and written out."""
    return moe_weight_bytes(dtype, model) \
        + 2 * b * model["hidden_size"] * BYTES[dtype]


def latent_width(model: dict = PUBLISHED) -> int:
    """A latent cache row: c_kv and k_pe."""
    return model["kv_lora_rank"] + model["qk_rope_head_dim"]


def attn_weight_bytes(dtype: str, model: dict = PUBLISHED) -> float:
    """A layer's attention weights: wq, wkv_a, the kv norm, wkv_b, wo."""
    return sum(math.prod(s[1:]) for s in _attn_shapes(model, 1).values()) \
        * BYTES[dtype]


def op_bytes(dims, dtype: str, model: dict = PUBLISHED) -> float:
    """One step's inputs read once and outputs written once: the attention
    weights of every layer, the dense layer's MLP, the expected distinct
    routed experts of each MoE layer (:func:`distinct_experts`) with its
    shared experts, router and bias, the norms, the head, the rows'
    embeddings, the latent cache read at mid-window (the visible positions
    halfway between prompt and max_len) with the step's rows written, and
    the logits written."""
    b, prompt, max_len = dims
    d, layers = model["hidden_size"], model["num_hidden_layers"]
    k = model["first_k_dense_replace"]
    by = BYTES[dtype]
    visible = (prompt + max_len) / 2
    cache = b * latent_width(model) * (visible + 1) * by
    per_layer = attn_weight_bytes(dtype, model) + 2 * d * by + cache
    moe = distinct_experts(b, model) * expert_bytes(dtype, model) \
        + moe_weight_bytes(dtype, model)
    dense = 3 * d * model["intermediate_size"] * by
    v = model["vocab_size"]
    return layers * per_layer + (layers - k) * moe + k * dense \
        + (d * v + d + b * d + b * v) * by


def op_ops(dims, model: dict = PUBLISHED) -> float:
    """One step: two operations a multiply-add of every projection a row
    runs in the absorbed form (q, kv_a, the absorption through W_UK and
    W_UV, wo; the dense MLP, or the k routed and the shared experts and
    the router; the head) and of attention's scores (576 wide) and output
    (512 wide) over the mid-window, every head."""
    b, prompt, max_len = dims
    d, layers = model["hidden_size"], model["num_hidden_layers"]
    k = model["first_k_dense_replace"]
    h, r = model["num_attention_heads"], model["kv_lora_rank"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    vd, f = model["v_head_dim"], model["moe_intermediate_size"]
    e, top = model["n_routed_experts"], model["num_experts_per_tok"]
    s = model["n_shared_experts"] * f
    attn = (d * h * (nope + rope) + d * (r + rope) + h * nope * r
            + h * r * vd + h * vd * d)
    moe = top * 3 * d * f + 3 * d * s + d * e
    dense = 3 * d * model["intermediate_size"]
    visible = (prompt + max_len) / 2
    scores = h * (latent_width(model) + r) * visible
    per_row = layers * (attn + scores) + (layers - k) * moe + k * dense \
        + d * model["vocab_size"]
    return 2.0 * b * per_row
