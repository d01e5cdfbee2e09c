"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA. [arXiv:2403.04652; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    act="silu",
    notes="Pure full attention: long_500k skipped per assignment.",
)
