"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (MHA kv=16) moe_d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,               # shared-expert aggregate width (4 x 1408)
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    act="silu",
    notes=("60 experts padded to 64 for expert parallelism over the 16-way "
           "model axis (documented in DESIGN.md). Pure full attention: "
           "long_500k skipped."),
)
