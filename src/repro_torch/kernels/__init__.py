"""CUDA kernels of the port, with the build/reference/baseline dispatch the
tuner uses.

Each kernel package has:
  kernel.py — the wrapper that launches the CUDA kernel (``csrc/*.cu``) on
              a CUDA tensor, or runs the plain version on a CPU tensor,
  plain.py  — the plain PyTorch version: the Pallas grid's per-block loop,
  ops.py    — the public wrapper (padding, dtype policy) and the kernel's
              block-shape gate,
  ref.py    — the plain PyTorch oracle of the op.

``build(workload, params, device)`` is the tuner's builder: it turns a
concrete schedule (:class:`KernelParams`) into a callable on ``device`` —
"cuda" (the default) launches the CUDA kernels, "cpu" runs the plain
versions. It routes through the process-wide content-addressed
:class:`~repro_torch.core.build_cache.BuildCache`, keyed by
``(params.signature(), backend)`` with backend "cuda" or "plain"; the
CUDA sources themselves are compiled once per process, at the first
launch (``_build.py``).

``baseline(workload)`` is the library yardstick, the JAX package's
``xla_baseline`` analogue: one PyTorch call (``torch.matmul``,
``torch._int_mm``). It is timed beside the kernels and never fills a
kernel slot.
"""

from __future__ import annotations

from repro_torch.core.build_cache import BuildCache, global_build_cache
from repro_torch.core.space import KernelParams
from repro_torch.core.workload import Workload

_BACKENDS = {"cuda": "cuda", "cpu": "plain"}


def _build_uncached(params: KernelParams, device: str):
    if params.op == "matmul":
        from repro_torch.kernels.matmul import ops
        return ops.build(params, device=device)
    if params.op == "qmatmul":
        from repro_torch.kernels.qmatmul import ops
        return ops.build(params, device=device)
    raise NotImplementedError(
        f"no kernel for op {params.op} yet (not ported, see ROADMAP)")


def build(workload: Workload, params: KernelParams, device: str = "cuda",
          cache: BuildCache | bool | None = None):
    """Concrete schedule -> callable over ``workload.example_inputs`` (numpy
    arrays or tensors), running on ``device`` ("cuda" or "cpu").

    Served from the process-wide build cache by default; ``cache=False``
    bypasses it, an explicit :class:`BuildCache` replaces it."""
    del workload  # the params carry everything the build consumes
    if device not in _BACKENDS:
        raise ValueError(f"device must be one of {sorted(_BACKENDS)}, "
                         f"got {device!r}")
    if cache is False:
        return _build_uncached(params, device)
    bc = cache if isinstance(cache, BuildCache) else global_build_cache()
    key = (params.signature(), _BACKENDS[device])
    return bc.get_or_build(key, lambda: _build_uncached(params, device))


def reference(workload: Workload):
    """The plain PyTorch oracle for an op family."""
    if workload.op == "matmul":
        from repro_torch.kernels.matmul.ref import matmul_ref
        return matmul_ref
    if workload.op == "qmatmul":
        from repro_torch.kernels.qmatmul.ref import qmatmul_ref
        return qmatmul_ref
    raise NotImplementedError(f"no reference for op {workload.op} yet")


def baseline(workload: Workload):
    """One PyTorch library call computing the op in the workload dtype —
    the yardstick the tuned kernels are compared with (``torch.matmul``;
    ``torch._int_mm`` for int8, plus the requantization for qmatmul)."""
    import torch

    from repro_torch.kernels.matmul.ops import TORCH_DTYPES

    if workload.op == "matmul":
        dtype = TORCH_DTYPES[workload.dtype]
        if dtype == torch.int8:
            return lambda x, w: torch._int_mm(x, w)
        return lambda x, w: torch.matmul(x.to(dtype), w.to(dtype))
    if workload.op == "qmatmul":
        from repro_torch.kernels.qmatmul.ops import DEFAULT_SCALE
        from repro_torch.kernels.qmatmul.plain import requantize

        return lambda x, w, bias: requantize(torch._int_mm(x, w), bias[None, :],
                                             DEFAULT_SCALE)
    raise NotImplementedError(f"no baseline for op {workload.op} yet")


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    from repro_torch.kernels.matmul import kernel as matmul_kernel
    from repro_torch.kernels.qmatmul import kernel as qmatmul_kernel

    return {**matmul_kernel.launches, **qmatmul_kernel.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.matmul import kernel as matmul_kernel
    from repro_torch.kernels.qmatmul import kernel as qmatmul_kernel

    for counts in (matmul_kernel.launches, qmatmul_kernel.launches):
        for name in counts:
            counts[name] = 0
