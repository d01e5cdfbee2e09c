"""Greedy decode of a latent-attention MoE model (Moonlight-16B-A3B, its
config.json's keys) through the port's ``Server``: the ``decode`` loop's
traffic, one client in a closed loop whose every request is one decode
step of all the batch's rows, sent as soon as the last step's tokens
reached the host. Each checked answer carries, beside the step's logits, the
experts its MoE layers chose (the decode state's ``experts``), which the
reference takes where they are within its band (``reference/<op>.py``).

Set-up draws the weights and the prompts from the seed on the device (the
op family's input rule, ``reference/<op>.py``), builds the model through
``model_zoo.build`` from the port's config with the published keys laid
over it, and a ``Server`` on those weights as they are held, prefills the
prompts into a latent cache of ``max_len`` positions through the
``Server``'s prefill, and warms up with ``warmup_steps`` steps, the first of
which captures the step as a CUDA graph. The rows (``decode.Rows``), the
traced steps (``decode.traced``: the graphed window, then eager steps with
the program's tracer on for the MoE layer's readers) and the checked
answers (the first step, one drawn from the seed among the first
``sample_steps``, and the last) are the ``decode`` loop's.
"""

from __future__ import annotations

import dataclasses
import random
import time

from portbench import harness, inputs
from portbench.loops import decode
from portbench.loops.passes import percentile
from portbench.reference import family


def port_config(config: dict):
    """The port's config of the cell: ``config["arch"]`` with the published
    keys of ``config["model"]`` and the op's dtype laid over it (for the
    cell itself they change nothing). A program without that config fails
    here, before anything is drawn."""
    from repro_torch.configs import get_config

    m, op = config["model"], config["ops"][0]
    return dataclasses.replace(
        get_config(config["arch"]),
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], head_dim=m["v_head_dim"],
        n_experts=m["n_routed_experts"], top_k=m["num_experts_per_tok"],
        moe_d_ff=m["moe_intermediate_size"],
        n_shared_experts=m["n_shared_experts"],
        d_ff=m["n_shared_experts"] * m["moe_intermediate_size"],
        norm_topk_prob=m["norm_topk_prob"], rope_theta=m["rope_theta"],
        norm_eps=m["rms_norm_eps"], vocab_size=m["vocab_size"],
        max_seq_len=m["max_position_embeddings"],
        kv_lora_rank=m["kv_lora_rank"], q_lora_rank=m["q_lora_rank"] or 0,
        qk_nope_head_dim=m["qk_nope_head_dim"],
        qk_rope_head_dim=m["qk_rope_head_dim"], v_head_dim=m["v_head_dim"],
        first_k_dense_replace=m["first_k_dense_replace"],
        dense_d_ff=m["intermediate_size"], scoring_func=m["scoring_func"],
        topk_method=m["topk_method"],
        routed_scaling_factor=m["routed_scaling_factor"], dtype=op["dtype"])


def serve(ctx, seed: int):
    """The ``Server`` of the cell on weights and prompts drawn from
    ``seed``: (server, weights, prompt ids)."""
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.serve_loop import Server

    config = ctx.cell.config
    op = config["ops"][0]
    cfg = port_config(config)
    weights, ids = family(op["op"]).inputs(
        op["dims"], op["dtype"], config["assumed"],
        inputs.generator(seed, ctx.device), ctx.device, model=config["model"])
    server = Server(build(cfg, device=ctx.device), weights,
                    max_len=op["dims"][2], cuda_graph=True)
    return server, weights, ids


def run(ctx) -> harness.Run:
    import torch

    config, traffic = ctx.cell.config, ctx.cell.traffic
    op = config["ops"][0]
    server, weights, ids = serve(ctx, ctx.seed)
    rows = decode.Rows(server, ids, op["dims"][2])
    for _ in range(traffic["warmup_steps"]):
        rows.step()
    trace, facts = None, {}
    if ctx.trace:
        trace, facts = decode.traced(ctx, rows, traffic["trace_steps"])

    ctx.setup_done()
    sample = random.Random(ctx.seed).randrange(1, traffic["sample_steps"])
    kept, latencies = [], []
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        i = len(latencies)
        t0 = time.perf_counter()
        pos = rows.step()
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if i in (0, sample):
            kept.append((rows.fed(pos), rows.state.logits.clone(),
                         rows.state.cache["experts"].clone()))
        if t1 >= end and i >= sample:
            break
    if i != sample:
        kept.append((rows.fed(pos), rows.state.logits,
                     rows.state.cache["experts"]))
    window_s = t1 - start
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    steps = len(latencies)
    # the program's state (its cache) goes before the reference runs; the
    # weights are the answers' inputs
    del rows, server
    answers = [harness.Answer(op["op"], (config["model"], weights, fed,
                                         experts), logits)
               for fed, logits, experts in kept]
    lat = sorted(latencies)
    e2e = {"infer_ms": window_s / steps * 1e3,
           "infer_p95_ms": percentile(lat, 95) * 1e3}
    return harness.Run(attempted=steps, end_to_end=e2e, answers=answers,
                       expected_answers=len({0, sample, i}),
                       memory_peak_bytes=peak, trace=trace, facts=facts)
