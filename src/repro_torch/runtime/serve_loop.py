"""Batched serving loop: prefill + decode with a static KV budget (the JAX
package's ``runtime/serve_loop.py``, ported).

This is also where the dispatch chain meets real traffic: a Server built
with a hardware config and a per-decode-step op list (:func:`decode_ops`)
resolves each step's tensor workloads through
``repro_torch.core.dispatch.best_schedule`` — tuned → bucketed → fixed →
xla — and reports the provenance mix on every :class:`GenerationResult`.
Misses flow into the attached :class:`~repro_torch.core.traffic.TrafficLog`,
which a :class:`~repro_torch.core.traffic.ContinuousTuner` drains; the
hot-swapping ``global_database()`` (or the database the server was given)
then flips later dispatches to ``"tuned"`` without a server restart. Built
without a hardware config (the default), the server is the plain
pre-dispatch serving loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.workload import Workload, gemv, matmul
from repro_torch.models.model_zoo import param_device


@dataclasses.dataclass
class DecodeState:
    """Where a batch of requests stands between two decode steps: the KV
    cache, the position the next step writes, the tokens it feeds (on the
    device), the tokens last produced (on the host, as a streaming server
    sends them) and the logits that produced them (on the device); and
    its step captured as a CUDA graph, where the server captures one."""
    cache: dict
    pos: int
    next_tok: torch.Tensor   # (B,) int32
    tokens: np.ndarray       # (B,)
    logits: torch.Tensor     # (B, V)
    graph: "_StepGraph | None" = None  # the step captured, on a card


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, prompt + n_steps) — exactly n_steps generated
    prefill_s: float
    decode_s: float
    steps: int
    # provenance -> op count of this step's dispatch resolution
    # ("tuned"/"bucketed"/"fixed"/"xla"); None when the server was built
    # without a dispatch layer (hw=None)
    dispatch: dict[str, int] | None = None


class _StepGraph:
    """One decode step of a state captured as a CUDA graph: the tokens it
    feeds and the position it writes are read from buffers of its own,
    filled before each replay, so one capture serves every later step of
    the state; the cache is the state's own, written in place. The logits
    and tokens it produces are its buffers too, overwritten by the next
    replay. A replay runs no Python: it records no span and counts
    nothing."""

    def __init__(self, server: "Server", state: DecodeState):
        self.tok = state.next_tok.clone()
        self.pos = torch.full((), state.pos, dtype=torch.int32,
                              device=server.device)

        def body():
            logits, cache = server.bundle.decode_fn(
                server.params, state.cache, self.tok[:, None], self.pos)
            if cache is not state.cache:
                raise ValueError("a captured step needs a decode that "
                                 "writes its cache in place")
            return logits, torch.argmax(logits, dim=-1).to(torch.int32)

        # warm-up off the capture: it writes the cache slot the first
        # replay writes, with the same values
        main = torch.cuda.current_stream(server.device)
        side = torch.cuda.Stream(server.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body()
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.next = body()

    def replay(self, state: DecodeState):
        """The step of ``state``: (logits, tokens) on the device."""
        self.tok.copy_(state.next_tok)
        self.pos.fill_(state.pos)
        self.graph.replay()
        return self.logits, self.next


def decode_ops(cfg, batch: int) -> list[tuple[int, Workload]]:
    """The per-decode-step tensor workloads of an ArchConfig, as
    ``[(count, Workload), ...]`` at the benchmarks/nets.py granularity (one
    entry per projection family, repeat counts for the layer stack).

    ``batch == 1`` lowers the projections to ``gemv`` — the single-stream
    edge-decode shape the paper tunes — larger batches to skinny matmuls.
    This is what a dispatch-aware :class:`Server` resolves every step, and
    what :func:`repro_torch.core.dispatch.ensure_tuned` pre-tunes offline.
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


class Server:
    """Minimal batched server: a fixed batch of requests is prefilled once,
    then decoded greedily step by step (one decode step reused across
    positions, called directly; the JAX package jits it). :meth:`prefill`
    and :meth:`step` are the step-level API a serving loop drives;
    :meth:`generate` runs them for a fixed number of steps. ``params`` is
    a :class:`~repro_torch.models.transformer.Model` or a nested dict of
    tensors under the same names (weights held as a checkpoint stores
    them, in its dtype).

    ``hw`` + ``serve_ops`` attach the dispatch layer: every ``generate``
    resolves each serve op once through the four-rung chain against
    ``database`` (default: the hot-swapping ``global_database()``) and
    records misses into ``traffic`` — the serving side of the
    continuous-tuning loop.

    ``cuda_graph=True`` replays each state's decode step as a CUDA graph
    on a card (:class:`_StepGraph`, captured at the state's first step),
    so that the host launches one graph a step instead of every operation
    of the model; steps taken while spans are recorded
    (:func:`repro_torch.tracing.recording`) run eagerly, so that their
    spans and counters are kept. For a family whose decode writes its
    cache in place, takes its position as a device tensor and waits for
    the host nowhere (the MoE family in bf16, whose grouped matmuls keep
    their group offsets on the card, without a ring or sliced cache).

    ``build_kernels=True`` additionally builds each resolved schedule's
    CUDA kernel, on the device of the model's parameters, during the
    dispatch pass. Builds go through the content-addressed process-wide
    :class:`~repro_torch.core.build_cache.BuildCache`, so only the *first*
    resolution of each distinct concrete lowering pays the build — steady
    state (the same ops resolving to the same schedules, generate after
    generate) performs zero builds."""

    def __init__(self, bundle, params, max_len: int = 256,
                 hw=None, serve_ops=None, traffic=None, database=None,
                 build_kernels: bool = False, cuda_graph: bool = False):
        self.bundle = bundle
        self.params = params
        self.max_len = max_len
        self.hw = hw
        self.serve_ops = list(serve_ops or ())
        self.traffic = traffic
        self.database = database
        self.build_kernels = build_kernels
        self.device = param_device(params)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        # signatures of the lowerings already launched once by _build_kernel
        self._launched: set = set()

    def resolve_dispatch(self) -> dict[str, int] | None:
        """One dispatch pass over the serve ops: provenance -> op count.
        None when no dispatch layer is attached. Each pass re-resolves
        through the database (hot-swap visible); per-op cost is O(1) via
        the dispatch caches."""
        if self.hw is None or not self.serve_ops:
            return None
        from repro_torch.core.dispatch import best_schedule

        counts: dict[str, int] = {}
        for count, wl in self.serve_ops:
            sched, provenance = best_schedule(wl, self.hw,
                                              database=self.database,
                                              traffic=self.traffic,
                                              count=count)
            counts[provenance] = counts.get(provenance, 0) + count
            if self.build_kernels and sched is not None:
                self._build_kernel(wl, sched)
        return counts

    def _build_kernel(self, wl: Workload, sched) -> None:
        """Build one resolved op's kernel through the process-wide build
        cache (a repeat of an already-built signature is a cache hit, no
        build). An "xla" resolution never reaches here (sched is None) and
        a schedule that does not concretize valid on this shape is skipped,
        as in the JAX package. The first time this server meets a concrete
        lowering on the card, its kernel is launched once on the workload's
        example inputs, so that a failing ``nvcc`` or launch raises here
        instead of being hidden."""
        from repro_torch import kernels
        from repro_torch.core import space as space_lib
        from repro_torch.core.runner import device_inputs

        params = space_lib.concretize(wl, self.hw, sched)
        if not params.valid:
            return
        fn = kernels.build(wl, params, device=self.device.type)
        sig = params.signature()
        if self.device.type == "cuda" and sig not in self._launched:
            with torch.cuda.device(self.device):
                fn(*device_inputs(wl, self.device))
            self._launched.add(sig)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prefill(self, prompts, extra_batch: dict | None = None
                ) -> DecodeState:
        """Prefill ``prompts`` (B, S) into a cache of ``max_len`` positions
        and pick each row's first token greedily: the state the first
        :meth:`step` decodes from."""
        with tracing.span("serve.prefill"):
            batch = {"tokens": prompts}
            if extra_batch:
                batch.update(extra_batch)
            logits, cache = self.bundle.prefill_fn(self.params, batch,
                                                   self.max_len)
            logits = logits[:, -1]
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return DecodeState(cache, prompts.shape[1], next_tok,
                               next_tok.cpu().numpy(), logits)

    @torch.no_grad()
    def step(self, state: DecodeState) -> np.ndarray:
        """One greedy decode step of every row: feeds ``state.next_tok`` at
        ``state.pos``, advances ``state`` and returns the new tokens (B,),
        once they are on the host. On a server with ``cuda_graph``, the
        state's ``logits`` and ``next_tok`` are then the graph's buffers,
        which the next step overwrites."""
        with tracing.span("serve.step"):
            if self.cuda_graph and not tracing.recording():
                if state.graph is None:
                    state.graph = _StepGraph(self, state)
                logits, next_tok = state.graph.replay(state)
            else:
                logits, state.cache = self.bundle.decode_fn(
                    self.params, state.cache, state.next_tok[:, None],
                    state.pos)
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            state.next_tok = next_tok
            state.pos += 1
            state.logits = logits
            state.tokens = next_tok.cpu().numpy()
            return state.tokens

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_steps: int,
                 extra_batch: dict | None = None) -> GenerationResult:
        dispatch = self.resolve_dispatch()
        b = prompts.shape[0]

        self._sync()
        t0 = time.perf_counter()
        state = self.prefill(prompts, extra_batch)
        self._sync()
        prefill_s = time.perf_counter() - t0

        # the prefill argmax is the *first* generated token, so it counts
        # against n_steps: n_steps=0 emits nothing (tokens == prompts) and
        # the result always has exactly prompt + n_steps columns
        out = [state.tokens] if n_steps > 0 else []
        t0 = time.perf_counter()
        for _ in range(n_steps - 1):
            out.append(self.step(state))
        self._sync()
        decode_s = time.perf_counter() - t0

        gen = (np.stack(out, axis=1).astype(prompts.dtype)
               if out else np.zeros((b, 0), dtype=prompts.dtype))
        return GenerationResult(np.concatenate([prompts, gen], axis=1),
                                prefill_s, decode_s, n_steps, dispatch)
