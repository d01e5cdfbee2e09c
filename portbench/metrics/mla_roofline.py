"""Serving (``kernels/csrc/mla_decode.cu``): the bytes the traced steps'
latent decode attention must move, at the HBM rate (``roofline.py``), over
the traced window's card time of the latent decode-attention kernel and its
merge of the splits, in %. The bytes: for traced step i at position ``pos =
prompt + (warmup_steps + i) mod (max_len - prompt)`` (the decode loop's
rows restart after their prompts), the latent rows of positions ``0..pos``
(c_kv and k_pe) once, and each head's query in (q_lat and q_pe) and its
latent output out, in every layer and row, at the op's dtype. None where no
such kernel ran in the window."""

from portbench import roofline
from portbench.metrics.attn_roofline import traced_positions

KERNEL = r"\bmla_decode_(kernel|combine)\b"
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def step_bytes(model: dict, batch: int, pos: int, dtype: str) -> float:
    """Bytes one decode step's latent attention must move at ``pos``, over
    every layer: the rows of positions 0..pos, q in and the output out."""
    lat = model["kv_lora_rank"]
    width = lat + model["qk_rope_head_dim"]
    heads = model["num_attention_heads"]
    per_layer = batch * (width * (pos + 1) + heads * (width + lat))
    return model["num_hidden_layers"] * per_layer * ITEMSIZE[dtype]


def read(run, cell):
    steps = run.facts.get("passes_traced")
    if run.trace is None or not steps:
        return None
    spent = run.trace.device_s(KERNEL)
    if spent <= 0:
        return None
    op = cell.config["ops"][0]
    moved = sum(step_bytes(cell.config["model"], op["dims"][0], pos,
                           op["dtype"])
                for pos in traced_positions(cell.config, cell.traffic, steps))
    return 100.0 * moved / roofline.HBM_BYTES_PER_S / spent
