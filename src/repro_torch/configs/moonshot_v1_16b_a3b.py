"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (MHA kv=16)
moe_d_ff=1408 vocab=163840, 64 routed experts top-6 (+2 shared, per the
Moonlight reference config). [hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=2816,               # shared-expert aggregate width (2 x 1408)
    vocab_size=163840,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    rope_theta=50000.0,
    tie_embeddings=False,
    act="silu",
    notes=("64 experts divide the 16-way model axis exactly (EP=16, 4 "
           "experts/shard). Pure full attention: long_500k skipped."),
)
