"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality) blocks. [arXiv:2405.21060;
unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    ssm_chunk=256,
    tie_embeddings=True,
    act="silu",
    notes=("Attention-free: the paper's attention kernel is N/A (op-level); "
           "SSD chunked matmuls dispatch through the tuned matmul intrinsics. "
           "long_500k applicable (O(1) state per token)."),
)
