"""MoE experts (``models/moe.py``): the experts whose weights a MoE layer
read at one step, over the traced steps' layer calls (the program's
counter ``moe.experts_read`` over its ``moe.ffn`` spans): about 14.5 for
a dropless layer at batch 4 under even routing, every held expert for one
that runs them all."""


def read(run, cell):
    calls = run.facts.get("moe_calls")
    experts = run.facts.get("experts_read")
    if not calls or experts is None:
        return None
    return experts / calls
