"""mobilellm-125m — the paper's own LLM evaluation network (seq len 64).
[arXiv:2402.14905]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mobilellm-125m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=32000,
    tie_embeddings=True,
    act="silu",
    max_seq_len=2048,
    notes="Paper's own benchmark net (tuned on the Banana Pi board).",
)
