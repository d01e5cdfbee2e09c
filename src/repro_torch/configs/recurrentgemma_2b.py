"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000. RG-LRU + local attention, 2 recurrent : 1 attention.
[arXiv:2402.19427; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    window_pattern=(2048,),  # attention blocks are local (window 2048)
    lru_width=2560,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    act="gelu",
    notes="Fixed-size recurrence + local attention -> long_500k applicable.",
)
