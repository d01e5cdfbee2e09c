"""Architecture & shape configuration system (a copy of the JAX package's
``configs/base.py``).

Every architecture is a frozen :class:`ArchConfig`; input shapes are
:class:`ShapeSpec` entries. ``reduced()`` derives the CPU smoke-test
configuration of the same family (small widths/depths, same code paths).
The port carries only the configurations a ported path uses
(:data:`EXTRA_IDS`); the JAX package's model pool is not ported.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention pattern ---
    # per-layer sliding-window sizes; -1 = full causal. Empty = all full.
    window_pattern: tuple[int, ...] = ()
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()  # (t, h, w) rotary sections (VLM)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 256
    # --- hybrid (RG-LRU) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500
    # --- misc ---
    tie_embeddings: bool = True
    embed_scale: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    max_seq_len: int = 524288
    notes: str = ""

    # ---------------------------------------------------------------- sizes --
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 128 so the vocab dim shards evenly over any mesh
        axis (Megatron-style padding; padded logits are masked)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def window_for_layer(self, i: int) -> int:
        if not self.window_pattern:
            return -1
        return self.window_pattern[i % len(self.window_pattern)]

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        p = v * d  # embedding
        if not self.tie_embeddings:
            p += v * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * f if self.act == "silu" else 2 * d * f
        if self.family == "moe":
            fe = self.moe_d_ff
            moe = (self.n_experts * 3 * d * fe
                   + self.n_shared_experts * 3 * d * fe + d * self.n_experts)
            p += self.n_layers * (attn + moe + 2 * d)
        elif self.family == "ssm":
            d_in = self.ssm_expand * d
            n = self.ssm_state
            heads = d_in // self.ssm_head_dim
            per = (d * (2 * d_in + 2 * n + heads)  # in_proj (z,x,B,C,dt)
                   + self.conv_kernel * (d_in + 2 * n)
                   + 2 * heads + d_in  # A, D, dt_bias... + norm
                   + d_in * d)  # out_proj
            p += self.n_layers * (per + d)
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = d * (2 * w) + self.conv_kernel * w + 2 * w * w + w + w * d
            n_rec = sum(1 for i in range(self.n_layers)
                        if self.block_kind(i) == "rec")
            n_att = self.n_layers - n_rec
            p += n_rec * (rec + mlp + 2 * d) + n_att * (attn + mlp + 2 * d)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            p += enc + dec + self.encoder_seq * d + self.max_decoder_pos() * d
        else:
            p += self.n_layers * (attn + mlp + 2 * d)
        p += d  # final norm
        return p

    def active_params(self) -> int:
        """Per-token active parameters (MoE counts top_k + shared only)."""
        if self.family != "moe":
            return self.num_params()
        d, fe = self.d_model, self.moe_d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        active_moe = ((self.top_k + self.n_shared_experts) * 3 * d * fe
                      + d * self.n_experts)
        p = self.vocab_size * d + self.n_layers * (attn + active_moe + 2 * d)
        return p

    def block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    def max_decoder_pos(self) -> int:
        """Learned decoder-position table size (encdec families); sized to
        cover every shape of the arch."""
        return self.max_seq_len

    # ------------------------------------------------------------- reduced --
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.block_pattern
                         else len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            max_seq_len=512,
            dtype="float32",
        )
        if self.family == "moe":
            # generous capacity: no token drops at smoke scale, so the
            # prefill/decode consistency checks are exact
            kw.update(n_experts=4, top_k=2,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=32, capacity_factor=8.0)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.family == "hybrid":
            kw.update(lru_width=64)
        if self.family == "encdec":
            kw.update(n_encoder_layers=2, encoder_seq=32)
        if self.window_pattern:
            kw.update(window_pattern=tuple(
                (w if w < 0 else min(w, 16)) for w in self.window_pattern))
        if self.mrope_sections:
            kw.update(mrope_sections=(4, 2, 2))
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# The JAX package's model pool (its ARCH_IDS) runs through its models, which
# are not ported; the port has none of them.
ARCH_IDS: tuple[str, ...] = ()

# The paper's own evaluation networks that a ported path uses:
# MobileLLM-125M's decode step (runtime.serve_loop.decode_ops).
EXTRA_IDS = ("mobilellm_125m",)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def supports_long_context(cfg: ArchConfig) -> bool:
    """Sub-quadratic (windowed / recurrent / SSM) path available?"""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return bool(cfg.window_pattern) and any(w > 0 for w in cfg.window_pattern)


def cells(arch_id: str) -> list[str]:
    """Shape names that apply to an arch (long_500k only with a
    sub-quadratic path)."""
    cfg = get_config(arch_id)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long_context(cfg):
        names.append("long_500k")
    return names
