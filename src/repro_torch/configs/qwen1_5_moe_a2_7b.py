"""qwen1.5-moe-a2.7b [moe] — Qwen1.5-MoE-A2.7B as published: 24L
d_model=2048 16H (MHA kv=16, head_dim 128) with q/k/v biases, 60 routed
SwiGLU experts of 1408 top-4 without renormalisation, dropless, and one
shared SwiGLU expert of 5632 scaled by sigmoid(x @ w_shared_gate).
Source: https://huggingface.co/Qwen/Qwen1.5-MoE-A2.7B/blob/main/config.json
(``Qwen2MoeForCausalLM``; transformers' ``Qwen2MoeSparseMoeBlock``).

``qwen2_moe_a2_7b`` is the JAX package's simplified copy of the same model;
this config follows the published layer where that one departs from it."""

from repro_torch.configs.base import PublishedArchConfig

CONFIG = PublishedArchConfig(
    name="qwen1.5-moe-a2.7b",
    family="moe",
    n_layers=24,             # num_hidden_layers; decoder_sparse_step 1
    d_model=2048,            # hidden_size
    n_heads=16,              # num_attention_heads
    n_kv_heads=16,           # num_key_value_heads
    head_dim=128,            # hidden_size / num_attention_heads
    d_ff=5632,               # shared_expert_intermediate_size
    vocab_size=151936,
    n_experts=60,            # num_experts
    n_shared_experts=4,      # one shared expert of 4 x 1408 = 5632
    top_k=4,                 # num_experts_per_tok
    moe_d_ff=1408,           # moe_intermediate_size
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    act="silu",
    norm_eps=1e-6,           # rms_norm_eps
    dtype="bfloat16",        # torch_dtype
    max_seq_len=8192,        # max_position_embeddings
    qkv_bias=True,
    shared_expert_gate=True,
    norm_topk_prob=False,
    moe_dropless=True,
    notes=("14.32 B parameters, about 2.7 B active a token. Dropless: no "
           "capacity and no padded experts (60 held, none padded)."),
)
