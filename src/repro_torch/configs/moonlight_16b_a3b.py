"""moonlight-16b-a3b [moe] — Moonlight-16B-A3B as published: 27L
d_model=2048, latent attention (MLA) of 16 heads over a 512 + 64 latent row
(no q compression), the first layer a dense SwiGLU of 11264, then 26 MoE
layers of 64 routed SwiGLU experts of 1408, top-6 chosen on sigmoid scores
plus a correction bias and weighted by the renormalised unbiased scores
times 2.446, beside two ungated shared experts of 1408.
Source (``model_type`` deepseek_v3):
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json

``moonshot_v1_16b_a3b`` is the JAX package's simplified copy of the same
model (plain multi-head attention, softmax routing, 48 layers); this config
follows the published one."""

from repro_torch.configs.base import PublishedArchConfig

CONFIG = PublishedArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,               # num_hidden_layers
    d_model=2048,              # hidden_size
    n_heads=16,                # num_attention_heads
    n_kv_heads=16,             # num_key_value_heads
    head_dim=128,              # v_head_dim: o_proj takes 16 x 128
    d_ff=2816,                 # the shared experts' width, 2 x 1408
    vocab_size=163840,         # vocab_size
    n_experts=64,              # n_routed_experts
    n_shared_experts=2,        # n_shared_experts
    top_k=6,                   # num_experts_per_tok
    moe_d_ff=1408,             # moe_intermediate_size
    rope_theta=50000.0,        # rope_theta; rope_scaling null
    tie_embeddings=False,      # tie_word_embeddings
    act="silu",                # hidden_act
    norm_eps=1e-5,             # rms_norm_eps
    dtype="bfloat16",          # torch_dtype
    max_seq_len=8192,          # max_position_embeddings
    norm_topk_prob=True,       # norm_topk_prob
    moe_dropless=True,         # no capacity in the published MoE block
    kv_lora_rank=512,          # kv_lora_rank
    q_lora_rank=0,             # q_lora_rank null
    qk_nope_head_dim=128,      # qk_nope_head_dim
    qk_rope_head_dim=64,       # qk_rope_head_dim
    v_head_dim=128,            # v_head_dim
    first_k_dense_replace=1,   # first_k_dense_replace; moe_layer_freq 1
    dense_d_ff=11264,          # intermediate_size
    scoring_func="sigmoid",    # scoring_func
    topk_method="noaux_tc",    # topk_method; n_group 1, topk_group 1
    routed_scaling_factor=2.446,  # routed_scaling_factor
    notes=("15.96 B parameters, about 3 B active a token. A latent cache "
           "row of 576 a token and layer. Dropless, 64 experts held."),
)
