"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144. 5:1 local:global sliding-window pattern, 128k-class context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    # 5 local (window 512) : 1 global, repeating.
    window_pattern=(512, 512, 512, 512, 512, -1),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    act="gelu",
    notes=("Windowed layers make the long_500k decode cell applicable; "
           "global layers at decode are O(seq) KV gathers (sequence-sharded)."),
)
