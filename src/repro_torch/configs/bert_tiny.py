"""bert-tiny — the paper's own NLP evaluation network (seq len 64).
Encoder-only transformer used by the benchmark suite."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert-tiny",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=30522,
    tie_embeddings=True,
    act="gelu",
    max_seq_len=512,
    notes="Paper's own benchmark net (Fig. 7/10); encoder-only, no decode.",
)
