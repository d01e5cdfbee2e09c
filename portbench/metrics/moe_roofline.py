"""MoE experts (``models/moe.py``): the bytes the traced steps' MoE layers
must move, at the HBM rate (``roofline.py``), over the card time of the
kernels launched inside the layer's ``moe.ffn`` spans, in %. The bytes: the
weights of each expert the layer read (the program's counter
``moe.experts_read``: the distinct routed-to experts) once, and at each
layer call the shared expert, router and shared-expert gate once and the
rows' activations in and out (``reference/<op>.py``'s ``expert_bytes`` and
``moe_fixed_bytes``). None where the traced run holds no such span or
kernel."""

from portbench import roofline
from portbench.reference import family


def read(run, cell):
    facts = run.facts
    kernels, calls = facts.get("moe_kernels"), facts.get("moe_calls")
    experts = facts.get("experts_read")
    if run.trace is None or not kernels or not calls or not experts:
        return None
    spent = sum(end - start for start, end, _ in kernels) / 1e9
    op = cell.config["ops"][0]
    fam, model = family(op["op"]), cell.config["model"]
    moved = experts * fam.expert_bytes(op["dtype"], model) \
        + calls * fam.moe_fixed_bytes(op["dims"][0], op["dtype"], model)
    return 100.0 * moved / roofline.HBM_BYTES_PER_S / spent
