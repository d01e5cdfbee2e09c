"""Serving (``kernels/csrc/decode_attention.cu``): the bytes the traced
steps' decode attention must move, at the HBM rate (``roofline.py``), over
the traced window's card time of the decode-attention kernel and its merge
of the splits, in %. The bytes: for traced step i at position ``pos =
prompt + (warmup_steps + i) mod (max_len - prompt)`` (the decode loop's
rows restart after their prompts), K and V of positions ``0..pos`` once,
and the query in and the output out, in every layer, row and head, at the
op's dtype. None where no such kernel ran in the window."""

from portbench import roofline

KERNEL = r"\bdecode_attention_(kernel|combine)\b"
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def step_bytes(model: dict, batch: int, pos: int, dtype: str) -> float:
    """Bytes one decode step's attention must move at ``pos``, over every
    layer: K and V of positions 0..pos, q in and the output out."""
    heads, kv_heads = model["num_attention_heads"], \
        model["num_key_value_heads"]
    head_dim = model["hidden_size"] // heads
    per_layer = batch * head_dim * (2 * kv_heads * (pos + 1) + 2 * heads)
    return model["num_hidden_layers"] * per_layer * ITEMSIZE[dtype]


def traced_positions(config: dict, traffic: dict, steps: int) -> list[int]:
    """The positions the traced window's steps feed."""
    _, prompt, max_len = config["ops"][0]["dims"]
    return [prompt + (traffic["warmup_steps"] + i) % (max_len - prompt)
            for i in range(steps)]


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
