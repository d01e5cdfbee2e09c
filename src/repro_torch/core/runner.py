"""Candidate measurement runners.

- :class:`CudaRunner` — builds each candidate on the port's CUDA kernels and
  times it on the card with CUDA events. The measuring runner.
- :class:`EmulateRunner` — the plain PyTorch versions of the kernels on the
  host CPU, timed by wall clock: the analogue of the JAX package's
  ``InterpretRunner``, for tests and runs without a card.
- :class:`AnalyticRunner` — the JAX package's deterministic TPU latency
  model, copied unchanged (its parity tests hold the port to the reference
  bit for bit). An H100 roofline is later work.

All satisfy the same ``Runner`` protocol; ``tuner.tune`` is agnostic. The
``overlap_capable`` class attribute tells the tuner whether measurement on
this runner takes real time worth hiding behind search: the CUDA and
emulate runners declare it, so ``tune(pipeline_depth > 1)`` and
``TuningSession`` evolve the next generation while the
:class:`~repro_torch.core.measure_scheduler.MeasureScheduler`'s measurement
thread times the current one; the analytic model does not, and is clamped
to the synchronous loop. ``max_inflight`` is how many submitted batches can
make progress at once: 1 for each of them (one card, one host).

These runners measure in the calling process. To measure each candidate in
a worker process of its own — killed at a per-candidate deadline, and
respawned when a kernel fault leaves its CUDA context unusable — wrap the
same measurement in :class:`~repro_torch.core.measure_pool.
SubprocessRunner`, or in a :class:`~repro_torch.core.board_farm.BoardFarm`
of :class:`~repro_torch.core.board_farm.LocalBoard` s (one per card).

Kernel builds go through the process-wide
:class:`~repro_torch.core.build_cache.BuildCache`, keyed by
``(params.signature(), backend)``; ``space.concretize`` is memoized per
(workload key, hardware name, schedule signature), as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core import space as space_lib
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload

INVALID = float("inf")


class Runner(Protocol):
    name: str
    hw: HardwareConfig

    def run(self, workload: Workload, schedule: Schedule) -> float:
        """Latency in seconds; inf if the candidate is invalid."""
        ...

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        """Latencies for a batch of candidates, aligned with ``schedules``."""
        ...


def run_batch(runner: Runner, workload: Workload,
              schedules: Sequence[Schedule]) -> list[float]:
    """Measure a batch on any runner, falling back to serial ``run`` calls
    for runners without ``run_batch``."""
    batched = getattr(runner, "run_batch", None)
    if batched is not None:
        return list(batched(workload, schedules))
    return [runner.run(workload, s) for s in schedules]


def device_inputs(workload: Workload, device: str = "cuda"):
    """``workload.example_inputs()`` as tensors on ``device``, floats in the
    workload dtype (so a bf16 workload's operands are bf16 in memory, and
    the measured call does not include casting them)."""
    import torch

    from repro_torch.kernels.matmul.ops import TORCH_DTYPES

    out = []
    for a in workload.example_inputs():
        t = torch.from_numpy(a)
        if t.is_floating_point():
            t = t.to(TORCH_DTYPES[workload.dtype])
        out.append(t.to(device))
    return tuple(out)


# Written before each timed call: more than the H100's 50 MB L2, so the
# cache does not hold the call's operands from the previous repeat.
_L2_FLUSH_BYTES = 64 << 20
# Card cycles spun before the start event (``torch.cuda._sleep``): the host
# has enqueued the call by the time the event is reached, so its launch cost
# stays outside the timed window.
_SPIN_CYCLES = 1_000_000


class CardTimer:
    """Times calls on the card with CUDA events: warmup, then the minimum
    over ``repeats``, each after an L2 flush and a short spin of the card."""

    def __init__(self, repeats: int = 10, warmup: int = 2):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("CardTimer needs a CUDA device")
        self.repeats, self.warmup = repeats, warmup
        self._flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda")

    def __call__(self, fn: Callable, inputs) -> float:
        """Seconds of the fastest of ``repeats`` calls of ``fn(*inputs)``.
        Span ``card_timer`` covers the call, its child ``card_timer.sync``
        the host's wait for the card: the rest is the host's enqueue."""
        import torch

        with tracing.span("card_timer", cpu=True):
            for _ in range(self.warmup):
                fn(*inputs)
            events = []
            for _ in range(self.repeats):
                self._flush.fill_(1)
                torch.cuda._sleep(_SPIN_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*inputs)
                end.record()
                events.append((start, end))
            with tracing.span("card_timer.sync"):
                torch.cuda.synchronize()
            return min(s.elapsed_time(e) for s, e in events) / 1e3


@dataclasses.dataclass
class CudaRunner:
    """Builds candidates on the CUDA kernels and times them on the card.

    A candidate is ``INVALID`` when it does not concretize to a valid block,
    when the kernel's gate rejects its block, or when the card refuses the
    launch (bad configuration, too many resources). A fault while a kernel
    runs (illegal address and the like) raises: the CUDA context is then
    unusable, and marking the candidate invalid would silently mark every
    later candidate invalid too. A kernel that never completes blocks the
    runner for good. To survive either, measure through
    :class:`~repro_torch.core.measure_pool.SubprocessRunner` or a
    :class:`~repro_torch.core.board_farm.LocalBoard`: each runs this runner
    in a worker process on its card, and a fault or a hang there costs the
    candidate (``INVALID``) and a worker respawn. No CPU fallback:
    constructing the runner without a card raises.

    Candidates are built, run and timed on the runner's own CUDA stream, on
    the card that was current when it was made, whichever thread calls: a
    background tuner can then measure beside a server decoding on the
    default stream, its work kept in order and apart from the server's
    thread. The stream does not isolate the timing: kernels the server
    issues meanwhile share the card's SMs, L2 and HBM and can run inside a
    timed window, and ``CardTimer``'s synchronize waits for the whole card.
    Latencies measured while a server decodes are measured under load.

    Candidates whose launches run the same kernel on the same layout
    (``kernels.launch_key``: qmatmul blocks that its wgmma loop takes at one
    bn, or that differ only in order or accumulate) are timed once per
    workload, and share that latency until ``clear_inputs``."""

    hw: HardwareConfig
    repeats: int = 10
    warmup: int = 2
    name: str = "cuda"
    # Real measurement on the card: the tuner may pipeline search behind it.
    overlap_capable = True
    # One card: submitted batches are measured one at a time.
    max_inflight = 1

    def __post_init__(self):
        from repro_torch.core.hardware import CudaHardwareConfig, check_device

        if not isinstance(self.hw, CudaHardwareConfig):
            raise ValueError(f"{self.hw.name} is not a CUDA configuration")
        import torch

        self._timer = CardTimer(self.repeats, self.warmup)
        check_device(self.hw)
        self._device = torch.cuda.current_device()
        self._stream = torch.cuda.Stream(self._device)
        self._inputs: dict[str, tuple] = {}
        self._timed: dict[tuple, float] = {}  # by (workload, launch key)

    def inputs(self, workload: Workload) -> tuple:
        key = workload.key()
        if key not in self._inputs:
            with tracing.span("runner.inputs", cpu=True):
                self._inputs[key] = device_inputs(workload, "cuda")
        return self._inputs[key]

    def clear_inputs(self) -> None:
        """Drop the operands kept on the card for every workload measured
        so far (a large model's LM head weight alone is 0.6 GB); the next
        measurement of a workload makes its operands anew, and times its
        launches anew."""
        self._inputs.clear()
        self._timed.clear()

    def _prepare(self, workload: Workload,
                 params: space_lib.KernelParams) -> Callable | None:
        """Build and run one valid candidate once; None if its launch is
        refused."""
        import torch

        from repro_torch import kernels
        from repro_torch.kernels._build import KernelLaunchError

        fn = kernels.build(workload, params, device="cuda")
        with tracing.span("runner.first_run", cpu=True):
            try:
                fn(*self.inputs(workload))
            except KernelLaunchError as exc:
                if exc.refused:
                    return None
                raise
            torch.cuda.synchronize()  # a fault during the run raises here
        return fn

    def run(self, workload: Workload, schedule: Schedule) -> float:
        import torch

        from repro_torch import kernels

        with tracing.span("runner.measure", cpu=True), \
                torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            # on a CUDA config, concretize already applies the kernel's own
            # launch gate (space.postproc_kernel_support)
            with tracing.span("space.concretize"):
                params = space_lib.concretize(workload, self.hw, schedule)
            if not params.valid:
                return INVALID
            key = kernels.launch_key(params)
            if key is not None:
                key = (workload.key(), key)
                if key in self._timed:
                    return self._timed[key]
            fn = self._prepare(workload, params)
            latency = (INVALID if fn is None
                       else self._timer(fn, self.inputs(workload)))
            if key is not None:
                self._timed[key] = latency
            return latency

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        return [self.run(workload, s) for s in schedules]


@dataclasses.dataclass
class EmulateRunner:
    """The kernels' plain PyTorch versions on the host CPU, timed by wall
    clock (min over ``repeats``) — the analogue of ``InterpretRunner``.
    Its latencies are host numbers, never the card's."""

    hw: HardwareConfig
    repeats: int = 3
    warmup: int = 1
    name: str = "emulate"
    # Real wall-clock measurement, as the JAX package's InterpretRunner.
    overlap_capable = True
    max_inflight = 1

    def run(self, workload: Workload, schedule: Schedule) -> float:
        from repro_torch import kernels

        with tracing.span("runner.measure", cpu=True):
            with tracing.span("space.concretize"):
                params = space_lib.concretize(workload, self.hw, schedule)
            if not params.valid:
                return INVALID
            fn = kernels.build(workload, params, device="cpu")
            inputs = device_inputs(workload, "cpu")
            with tracing.span("runner.first_run", cpu=True):
                for _ in range(self.warmup):
                    fn(*inputs)
            best = INVALID
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                fn(*inputs)
                best = min(best, time.perf_counter() - t0)
            return best

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        return [self.run(workload, s) for s in schedules]


@dataclasses.dataclass
class AnalyticRunner:
    """Deterministic v5e latency model (the JAX package's, unchanged)."""

    hw: HardwareConfig
    name: str = "analytic"
    # Evaluate each distinct trace signature in a batch once. The model is
    # a deterministic function of the concretized params, so dedup-on is
    # identical to dedup-off.
    dedup: bool = False
    # Instantaneous measurement: nothing for the tuner pipeline to hide
    # behind, so the tuner clamps the pipeline depth to 1 for this runner.
    overlap_capable = False
    max_inflight = 1

    def run(self, workload: Workload, schedule: Schedule) -> float:
        params = space_lib.concretize(workload, self.hw, schedule)
        return self.latency(workload, params)

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        if not self.dedup:
            return [self.run(workload, s) for s in schedules]
        memo: dict = {}
        out = []
        for s in schedules:
            sig = s.signature()
            if sig not in memo:
                memo[sig] = self.run(workload, s)
            out.append(memo[sig])
        return out

    def latency(self, workload: Workload,
                params: space_lib.KernelParams) -> float:
        if not params.valid:
            return INVALID
        hw = self.hw
        # --- compute term with MXU utilization derating ---------------------
        flops = workload.flops()
        # padded-shape waste counts as issued compute
        pad = (float(np.prod(params.padded_dims))
               / max(float(np.prod(workload.dims)), 1.0))
        bm = params.block[0]
        bn = params.block[1] if len(params.block) > 1 else hw.mxu_dim
        bk = params.block[2] if len(params.block) > 2 else bn
        if params.op in ("matmul", "qmatmul", "gemv", "attention"):
            util = (min(bm, hw.mxu_dim) / hw.mxu_dim) \
                 * (min(bn, hw.mxu_dim) / hw.mxu_dim) \
                 * (min(bk, hw.mxu_dim) / hw.mxu_dim)
            util = max(util, 1e-3) ** (1.0 / 3.0)  # geometric-mean derate
        else:
            util = 1.0  # VPU elementwise
        t_compute = flops * pad / (hw.peak_flops(workload.dtype) * util)
        # --- memory term ------------------------------------------------------
        traffic = space_lib.hbm_traffic_bytes(workload, params)
        t_memory = traffic / hw.hbm_bandwidth
        # --- grid overhead ----------------------------------------------------
        steps = float(np.prod(params.grid))
        t_overhead = steps * hw.grid_step_overhead_s
        # DMA/compute overlap: roofline max, plus fixed per-step cost.
        return max(t_compute, t_memory) + t_overhead


def default_runner(hw: HardwareConfig):
    """The runner that measures where ``hw`` says the kernels run:
    :class:`CudaRunner` on the card for a CUDA configuration (raising
    without one; no CPU fallback), the analytic model for a TPU one, as in
    the JAX package."""
    from repro_torch.core.hardware import CudaHardwareConfig

    if isinstance(hw, CudaHardwareConfig):
        return CudaRunner(hw)
    return AnalyticRunner(hw)


def baseline_latency(workload: Workload, device: str = "cuda",
                     repeats: int = 10) -> float:
    """Time the library baseline of the op (``kernels.baseline``, the JAX
    package's ``xla_latency`` analogue) on ``device``: CUDA events on the
    card, wall clock on "cpu"."""
    from repro_torch import kernels

    fn = kernels.baseline(workload)
    if device == "cuda":
        timer = CardTimer(repeats=repeats)  # raises without a card
        return timer(fn, device_inputs(workload, device))
    inputs = device_inputs(workload, device)
    fn(*inputs)
    best = INVALID
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*inputs)
        best = min(best, time.perf_counter() - t0)
    return best
