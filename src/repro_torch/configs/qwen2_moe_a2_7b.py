"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (MHA kv=16) moe_d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The JAX package's simplified copy of that model, kept as the JAX package
has it (its parity tests pair with it). It departs from the published
layer in four ways: it renormalises the top-k weights (a softmax over the
top-k logits alone, where the published router keeps the softmax over all
60 unrenormalised); its shared expert has no sigmoid gate; its q, k and v
projections have no biases; and it routes with capacity, padding the
experts to 64, so assignments past an expert's capacity are dropped. The
published model is ``qwen1_5_moe_a2_7b``."""

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
