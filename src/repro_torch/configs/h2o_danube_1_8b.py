"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000. Llama+Mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    window_pattern=(4096,),  # Mistral-style SWA on every layer
    rope_theta=10000.0,
    tie_embeddings=False,
    act="silu",
    notes="SWA everywhere -> long_500k applicable (window 4096).",
)
