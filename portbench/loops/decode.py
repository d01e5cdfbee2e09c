"""Greedy decode through the port's ``Server``: one client in a closed loop
whose every request is one decode step of all the batch's rows, sent as
soon as the last step's tokens reached the host.

Set-up draws the weights and the prompts from the seed on the device (the
op family's input rule, ``reference/<op>.py``), builds the model through
``model_zoo.build`` and a ``Server`` on those weights as they are held,
prefills the prompts into a cache of ``max_len`` positions through the
``Server``'s prefill, and warms up with ``warmup_steps`` steps, the first
of which captures the step as a CUDA graph on a card (``Server``'s
``cuda_graph``). A traced run then profiles ``trace_steps`` steps as the
window times them, the traced window, and after it ``trace_steps`` more
with the program's tracer on (``repro_torch.tracing``), which run
eagerly: of those it keeps what the readers of the MoE layer's metrics
need, the card time of the kernels launched inside its ``moe.ffn`` spans
and its counters. When the rows reach ``max_len`` positions they restart
after their prompts, keeping the prefilled cache.

The window checks three steps: the first, one drawn from the seed among the
first ``sample_steps``, and the last; each answer is a step's logits with
every token its rows were fed. The traffic file's keys: ``warmup_steps``,
``trace_steps``, ``sample_steps``, ``rotate_bytes`` (one step moves more
than the L2 holds many times over, so one set of weights suffices).
"""

from __future__ import annotations

import bisect
import dataclasses
import random
import time

import numpy as np

from portbench import harness, inputs
from portbench import trace as ptrace
from portbench.loops.passes import percentile
from portbench.reference import family

MOE_SPAN = "moe.ffn"


def port_config(config: dict):
    """The port's config of the cell: ``config["arch"]`` with the
    published keys of ``config["model"]`` and the op's dtype laid over it
    (for the cell itself they change nothing). A program without that
    config fails here, before anything is drawn."""
    from repro_torch.configs import get_config

    m, op = config["model"], config["ops"][0]
    return dataclasses.replace(
        get_config(config["arch"]),
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m["hidden_size"] // m["num_attention_heads"],
        n_experts=m["num_experts"], top_k=m["num_experts_per_tok"],
        moe_d_ff=m["moe_intermediate_size"],
        d_ff=m["shared_expert_intermediate_size"],
        n_shared_experts=m["shared_expert_intermediate_size"]
        // m["moe_intermediate_size"],
        norm_topk_prob=m["norm_topk_prob"], rope_theta=m["rope_theta"],
        norm_eps=m["rms_norm_eps"], vocab_size=m["vocab_size"],
        max_seq_len=m["max_position_embeddings"], dtype=op["dtype"])


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


class Rows:
    """The batch's decode state and every token its rows were fed: a step
    at a time through ``server.step``, each row restarting after its
    prompt when the cache is full."""

    def __init__(self, server, ids, max_len: int):
        self.server = server
        self.prompt = ids.shape[1]
        self.max_len = max_len
        self.seq = np.zeros((ids.shape[0], max_len), dtype=np.int64)
        self.seq[:, :self.prompt] = ids.cpu().numpy()
        self.state = server.prefill(ids)

    def step(self) -> int:
        """One step; returns the position it fed."""
        state = self.state
        if state.pos == self.max_len:
            state.pos = self.prompt
        pos = state.pos
        self.seq[:, pos] = state.tokens
        self.server.step(state)
        return pos

    def fed(self, pos: int) -> np.ndarray:
        return self.seq[:, :pos + 1].copy()


def launched_in(host_ops, device_ops, spans) -> list[tuple]:
    """The device operations whose launching host operation started inside
    one of ``spans``: ``host_ops`` [(correlation id, start ns)] of the
    profiler's frontend operations, ``device_ops`` [(linked correlation
    id, start ns, end ns, name)], ``spans`` [(start ns, end ns)] on the
    same clock. Returns [(start ns, end ns, name)]."""
    started = dict(host_ops)
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    out = []
    for link, start, end, name in device_ops:
        t = started.get(link)
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= spans[j][1]:
            out.append((start, end, name))
    return out


def profile_links(prof, torch):
    """(host_ops, device_ops) of :func:`launched_in` from a profile: each
    device operation is linked to the frontend operation that launched
    it, as ``torch.profiler`` links kernels to operators."""
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                start = e.start_ns()
                device.append((e.linked_correlation_id(), start,
                               start + e.duration_ns(), e.name()))
        elif e.linked_correlation_id() == 0:
            host.append((e.correlation_id(), e.start_ns()))
    return host, device


def traced(ctx, rows: Rows, n: int):
    """``n`` steps profiled as the window takes them, the traced window,
    then ``n`` with the program's tracer on: (trace, facts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import tracing

    activities = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tracing.collect()
    with profile(activities=activities) as prof:
        with record_function(ptrace.WINDOW):
            for _ in range(n):
                rows.step()
            ctx.sync()
        before = tracing.counters()
        tracing.enable()
        try:
            for _ in range(n):
                rows.step()
            ctx.sync()
        finally:
            tracing.disable()
    after = tracing.counters()
    spans = [(s.start_ns, s.end_ns) for s in tracing.collect()
             if s.name == MOE_SPAN]

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    facts = {"passes_traced": n, "moe_calls": len(spans),
             "experts_read": delta("moe.experts_read"),
             "moe_dropped": delta("moe.dropped"),
             "moe_kernels": launched_in(*profile_links(prof, torch), spans)}
    return ptrace.Trace.from_profile(prof, torch), facts


def run(ctx) -> harness.Run:
    import torch

    config, traffic = ctx.cell.config, ctx.cell.traffic
    op = config["ops"][0]
    server, weights, ids = serve(ctx, ctx.seed)
    rows = Rows(server, ids, op["dims"][2])
    for _ in range(traffic["warmup_steps"]):
        rows.step()
    trace, facts = None, {}
    if ctx.trace:
        trace, facts = traced(ctx, rows, traffic["trace_steps"])

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
            kept.append((rows.fed(pos), rows.state.logits.clone()))
        if t1 >= end and i >= sample:
            break
    if i != sample:
        kept.append((rows.fed(pos), rows.state.logits))
    window_s = t1 - start
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    steps = len(latencies)
    # the program's state (its cache) goes before the reference runs; the
    # weights are the answers' inputs
    del rows, server
    answers = [harness.Answer(op["op"], (config["model"], weights, fed),
                              logits) for fed, logits in kept]
    lat = sorted(latencies)
    e2e = {"infer_ms": window_s / steps * 1e3,
           "infer_p95_ms": percentile(lat, 95) * 1e3}
    return harness.Run(attempted=steps, end_to_end=e2e, answers=answers,
                       expected_answers=len({0, sample, i}),
                       memory_peak_bytes=peak, trace=trace, facts=facts)
