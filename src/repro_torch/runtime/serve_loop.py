"""The serving loop's per-decode-step op list (the JAX package's
``runtime/serve_loop.py``, in part).

Only :func:`decode_ops` is ported: it is what
:func:`repro_torch.core.dispatch.ensure_tuned` pre-tunes for a decoding
server. The JAX package's ``Server`` needs its models, which the port does
not have yet.
"""

from __future__ import annotations

from repro_torch.core.workload import Workload, gemv, matmul


def decode_ops(cfg, batch: int) -> list[tuple[int, Workload]]:
    """The per-decode-step tensor workloads of an ArchConfig, as
    ``[(count, Workload), ...]`` at the benchmarks/nets.py granularity (one
    entry per projection family, repeat counts for the layer stack).

    ``batch == 1`` lowers the projections to ``gemv`` — the single-stream
    edge-decode shape the paper tunes — larger batches to skinny matmuls.
    This is what a dispatch-aware server resolves every step, and what
    :func:`repro_torch.core.dispatch.ensure_tuned` pre-tunes offline.
    """
    dtype = cfg.dtype if cfg.dtype in ("float32", "bfloat16") else "bfloat16"

    def proj(n: int, k: int) -> Workload:
        return (gemv(n, k, dtype) if batch == 1
                else matmul(batch, n, k, dtype))

    ff = cfg.moe_d_ff if (cfg.family == "moe" and cfg.moe_d_ff) else cfg.d_ff
    n_up = 2 if cfg.act == "silu" else 1  # gated acts: up + gate projections
    return [
        (cfg.n_layers, proj(cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model)),  # QKV
        (cfg.n_layers, proj(cfg.d_model, cfg.q_dim)),      # attention out
        (n_up * cfg.n_layers, proj(ff, cfg.d_model)),      # FFN up (+ gate)
        (cfg.n_layers, proj(cfg.d_model, ff)),             # FFN down
        (1, proj(cfg.padded_vocab, cfg.d_model)),          # LM head
    ]
