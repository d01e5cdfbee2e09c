"""One greedy decode step of Qwen1.5-MoE-A2.7B at batch B, dims (B, prompt,
max_len): each row's logits at the step's position, given every token the
row has been fed. Its input rule, plain reference, control, comparison,
bytes and operations.

Plain PyTorch, importing nothing of the program: the model is written again
from its published description (the Hugging Face ``config.json`` of
Qwen/Qwen1.5-MoE-A2.7B, ``Qwen2MoeForCausalLM``, and transformers'
``Qwen2MoeSparseMoeBlock``): RMSNorm, q/k/v projections with bias, RoPE by
rotate-half, causal softmax attention, then a router softmaxed over all 60
experts in f32 whose top-4 weights are kept as they are
(``norm_topk_prob`` false), each routed token run through its experts'
SwiGLU with no capacity, plus one shared SwiGLU expert scaled by
``sigmoid(x @ w_shared_gate)``. The reference runs the whole sequence
again in float32 with TF32 off: no cache, no batching of rows' positions.
Departures, none of which changes the mathematics: the layers' weights are
upcast to f32 one layer at a time, attention runs a row and a block of
queries at a time, and an expert runs on the rows that chose it (the
published block's loop over experts), so that it fits on the card beside
the program's weights; RoPE's angles are computed in float64.

The weights are a nested dict, the layers stacked on a leading axis, each
projection stored (in, out) so that ``y = x @ w``: ``embedding`` (V, D),
``lm_head`` (D, V), ``final_norm`` (D,), and under ``layers``: ``ln1``,
``ln2`` (L, D); ``attn``: ``wq``, ``wk``, ``wv`` (L, D, H*hd), ``wo`` (L,
H*hd, D), ``bq``, ``bk``, ``bv`` (L, H*hd); ``router`` (L, D, E);
``experts``: ``w_gate``, ``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D);
``shared``: ``w_gate``, ``w_up`` (L, D, S), ``w_down`` (L, S, D);
``shared_gate`` (L, D, 1).
"""

from __future__ import annotations

import math

import torch

# The largest ||got - ref||_2 / ||ref||_2 over the checked rows' logits.
# The program (bf16 weights, activations and cache; a few tokens a layer
# whose 4th and 5th experts lie closer than bf16 resolves route
# elsewhere) read 0.0304-0.0556 on 24 seeds at the cell's sizes, the
# float8 control 0.176-0.210 on 6 (PERF.md section 2): the limit lies
# near their geometric mean, 1.8 times above the one and below the other.
NUMBER, LIMIT, COMBINE = "decode_logit_rel_err", 0.1, "max"

# The published config.json's values (head_dim is hidden / heads).
PUBLISHED = {
    "hidden_size": 2048, "num_hidden_layers": 24, "num_attention_heads": 16,
    "num_key_value_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "norm_topk_prob": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "vocab_size": 151936, "max_position_embeddings": 8192,
    "decoder_sparse_step": 1, "tie_word_embeddings": False,
}
BYTES = {"bfloat16": 2, "float32": 4}


# ---------------------------------------------------------------- shapes --

def shapes(model: dict) -> dict:
    """Each weight's shape, under the names the module docstring gives."""
    d, layers = model["hidden_size"], model["num_hidden_layers"]
    h, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    e, f = model["num_experts"], model["moe_intermediate_size"]
    s, v = model["shared_expert_intermediate_size"], model["vocab_size"]
    return {
        "embedding": (v, d), "lm_head": (d, v), "final_norm": (d,),
        "layers": {
            "ln1": (layers, d), "ln2": (layers, d),
            "attn": {"wq": (layers, d, h * hd), "wk": (layers, d, kv * hd),
                     "wv": (layers, d, kv * hd), "wo": (layers, h * hd, d),
                     "bq": (layers, h * hd), "bk": (layers, kv * hd),
                     "bv": (layers, kv * hd)},
            "router": (layers, d, e),
            "experts": {"w_gate": (layers, e, d, f),
                        "w_up": (layers, e, d, f),
                        "w_down": (layers, e, f, d)},
            "shared": {"w_gate": (layers, d, s), "w_up": (layers, d, s),
                       "w_down": (layers, s, d)},
            "shared_gate": (layers, d, 1),
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
    router, shared-expert gate, embedding and head normal with a spread of
    ``init_std``, the q/k/v biases of ``qkv_bias_std``, the norms ones."""
    def draw(name, shape):
        if name.startswith("ln") or name == "final_norm":
            return torch.ones(shape, dtype=dtype, device=device)
        std = assumed["qkv_bias_std"] if name in ("bq", "bk", "bv") \
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


def _rope(x, positions, theta: float):
    """Rotate-half RoPE of x (B, L, H, hd) at ``positions`` (L,)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = positions.to(torch.float64)[:, None] * inv[None]     # (L, hd/2)
    ang = torch.cat([ang, ang], dim=-1)
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q, k, v, mm, block: int = 1024):
    """Causal softmax attention of q (B, L, H, hd) over k, v (B, L, KV,
    hd), query head h reading KV head h // (H / KV); a row and ``block``
    queries at a time. Returns (B, L, H * hd)."""
    b, n, h, hd = q.shape
    group = h // k.shape[2]
    out = torch.empty(b, n, h * hd, dtype=q.dtype, device=q.device)
    for r in range(b):
        kr = k[r].repeat_interleave(group, dim=1).transpose(0, 1)  # (H,L,hd)
        vr = v[r].repeat_interleave(group, dim=1).transpose(0, 1)
        for i in range(0, n, block):
            qi = q[r, i:i + block].transpose(0, 1)                 # (H,c,hd)
            c = qi.shape[1]
            scores = mm(qi, kr[:, :i + c].transpose(1, 2)) / math.sqrt(hd)
            rows = torch.arange(i, i + c, device=q.device)[:, None]
            cols = torch.arange(i + c, device=q.device)[None, :]
            scores = scores.masked_fill(cols > rows, float("-inf"))
            o = mm(torch.softmax(scores, dim=-1), vr[:, :i + c])   # (H,c,hd)
            out[r, i:i + c] = o.transpose(0, 1).reshape(c, h * hd)
    return out


def _layer(x, lw: dict, model: dict, mm):
    b, n, d = x.shape
    h, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    eps = model["rms_norm_eps"]
    a = lw["attn"]
    t = _rms(x, lw["ln1"], eps)
    q = (mm(t, a["wq"]) + a["bq"]).view(b, n, h, hd)
    k = (mm(t, a["wk"]) + a["bk"]).view(b, n, kv, hd)
    v = (mm(t, a["wv"]) + a["bv"]).view(b, n, kv, hd)
    positions = torch.arange(n, device=x.device)
    q = _rope(q, positions, model["rope_theta"])
    k = _rope(k, positions, model["rope_theta"])
    x = x + mm(_attention(q, k, v, mm), a["wo"])

    t = _rms(x, lw["ln2"], eps).reshape(b * n, d)
    probs = torch.softmax(mm(t, lw["router"]), dim=-1)            # (T, E)
    weight, chosen = torch.topk(probs, model["num_experts_per_tok"], dim=-1)
    if model["norm_topk_prob"]:
        weight = weight / weight.sum(-1, keepdim=True)
    y = torch.zeros_like(t)
    ex = lw["experts"]
    for e in range(model["num_experts"]):
        tok, slot = torch.where(chosen == e)
        if tok.numel():
            te = t[tok]
            act = torch.nn.functional.silu(mm(te, ex["w_gate"][e])) \
                * mm(te, ex["w_up"][e])
            y.index_add_(0, tok, mm(act, ex["w_down"][e])
                         * weight[tok, slot, None])
    sh = lw["shared"]
    shared = mm(torch.nn.functional.silu(mm(t, sh["w_gate"]))
                * mm(t, sh["w_up"]), sh["w_down"])
    y = y + torch.sigmoid(mm(t, lw["shared_gate"])) * shared
    return x + y.view(b, n, d)


def _layer_weights(tree: dict, i: int, device) -> dict:
    """Layer ``i``'s weights upcast to float32."""
    return {name: _layer_weights(v, i, device) if isinstance(v, dict)
            else v[i].to(device=device, dtype=torch.float32)
            for name, v in tree.items()}


def logits_at_last(model: dict, w: dict, tokens, lowp: bool = False):
    """The logits (B, V) at the last position of ``tokens`` (B, L): the
    forward pass over the whole of each row, in float32 (TF32 off), or
    with every matmul's inputs rounded to float8 e4m3 (``lowp``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _matmul(lowp)
    device = w["embedding"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    with torch.no_grad():
        x = w["embedding"][tokens].to(torch.float32)
        for i in range(model["num_hidden_layers"]):
            x = _layer(x, _layer_weights(w["layers"], i, device), model, mm)
        last = _rms(x[:, -1], w["final_norm"].float(), model["rms_norm_eps"])
        return mm(last, w["lm_head"].float())


def reference(args, assumed: dict) -> torch.Tensor:
    model, w, tokens = args
    return logits_at_last(model, w, tokens)


def control(args, assumed: dict) -> torch.Tensor:
    """The reference with float8 e4m3 at every matmul input: the precision
    below the configuration's bfloat16."""
    model, w, tokens = args
    return logits_at_last(model, w, tokens, lowp=True)


def error(got, want, args) -> float:
    """The largest ||got - want||_2 / ||want||_2 over the rows."""
    if got.shape != want.shape:
        return float("inf")
    got = got.to(device=want.device, dtype=torch.float32)
    rel = torch.linalg.vector_norm(got - want, dim=-1) \
        / torch.linalg.vector_norm(want, dim=-1)
    return float(rel.max())


# ----------------------------------------------------- bytes, operations --

def distinct_experts(b: int, model: dict = PUBLISHED) -> float:
    """Experts a layer reads at one step of ``b`` rows under uniform
    routing: each expert is left out by a row with probability 1 - k/E."""
    e, k = model["num_experts"], model["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** b)


def expert_bytes(dtype: str, model: dict = PUBLISHED) -> float:
    """One routed expert's gate, up and down weights."""
    return 3 * model["hidden_size"] * model["moe_intermediate_size"] \
        * BYTES[dtype]


def moe_weight_bytes(dtype: str, model: dict = PUBLISHED) -> float:
    """A MoE layer's weights besides its routed experts: the shared
    expert, the router and the shared expert's gate."""
    d = model["hidden_size"]
    return (3 * d * model["shared_expert_intermediate_size"]
            + d * model["num_experts"] + d) * BYTES[dtype]


def moe_fixed_bytes(b: int, dtype: str, model: dict = PUBLISHED) -> float:
    """What a MoE layer moves at a step of ``b`` rows besides its routed
    experts: :func:`moe_weight_bytes` read once, and the rows'
    activations read in and written out."""
    return moe_weight_bytes(dtype, model) \
        + 2 * b * model["hidden_size"] * BYTES[dtype]


def op_bytes(dims, dtype: str, model: dict = PUBLISHED) -> float:
    """One step's inputs read once and outputs written once: the attention
    weights and biases, the expected distinct routed experts
    (:func:`distinct_experts`), the shared expert, router and gate, the
    norms, the head, the rows' embeddings, the KV cache read at
    mid-window (the visible positions halfway between prompt and max_len)
    with the step's keys and values written, and the logits written."""
    b, prompt, max_len = dims
    d, layers = model["hidden_size"], model["num_hidden_layers"]
    kv = model["num_key_value_heads"] * (d // model["num_attention_heads"])
    by = BYTES[dtype]
    attn = (2 * d * d + 2 * d * kv + d + 2 * kv) * by
    moe = distinct_experts(b, model) * expert_bytes(dtype, model) \
        + moe_weight_bytes(dtype, model)
    visible = (prompt + max_len) / 2
    cache = 2 * b * kv * (visible + 1) * by
    per_layer = attn + moe + 2 * d * by + cache
    v = model["vocab_size"]
    return layers * per_layer + (d * v + d + b * d + b * v) * by


def op_ops(dims, model: dict = PUBLISHED) -> float:
    """One step: two operations a multiply-add of every projection a row
    runs (attention, its k routed and the shared expert, router, gate,
    head) and of attention's scores and values over the mid-window."""
    b, prompt, max_len = dims
    d, layers = model["hidden_size"], model["num_hidden_layers"]
    h = model["num_attention_heads"]
    kv = model["num_key_value_heads"] * (d // h)
    f, s = model["moe_intermediate_size"], \
        model["shared_expert_intermediate_size"]
    k, e = model["num_experts_per_tok"], model["num_experts"]
    per_row = (2 * d * d + 2 * d * kv + k * 3 * d * f + 3 * d * s
               + d * e + d)
    visible = (prompt + max_len) / 2
    attn = 2 * 2 * h * (d // h) * visible
    return 2.0 * b * (layers * per_row + d * model["vocab_size"]) \
        + b * layers * attn
