"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. M-RoPE (3-axis rotary), dynamic-resolution vision frontend is
a STUB: input_specs() provides precomputed patch embeddings.
[arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),  # temporal/height/width rotary sections
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    act="silu",
    notes="Pure full attention: long_500k skipped per assignment.",
)
