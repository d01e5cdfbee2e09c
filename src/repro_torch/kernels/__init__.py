"""CUDA kernels of the port, and the one seam between them and the tuner.

Each kernel package has:
  kernel.py — the wrapper that launches the CUDA kernel (``csrc/*.cu``) on
              a CUDA tensor, or runs the plain version on a CPU tensor,
  plain.py  — the plain PyTorch version: the Pallas grid's per-block loop,
  ops.py    — the public wrapper (dtype policy; padding to the block
              where the kernel needs it: the qmatmul and vmacc kernels
              mask their tail tiles and take no padding) and the family's
              answers to the tuner,
  ref.py    — the plain PyTorch oracle of the op.

The tuner asks a kernel family only through :func:`family`: the answers
:class:`Family` names, which each ``ops.py`` gives as its ``FAMILY``.

``build(workload, params, device)`` is the tuner's builder: it turns a
concrete schedule (:class:`KernelParams`) into a callable on ``device`` —
"cuda" (the default) launches the CUDA kernels, "cpu" runs the plain
versions. It routes through the process-wide content-addressed
:class:`~repro_torch.core.build_cache.BuildCache`, keyed by
``(params.signature(), backend)`` with backend "cuda" or "plain"; the
CUDA sources themselves are compiled once per process, at the first
launch (``_build.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable

from repro_torch import tracing
from repro_torch.core.build_cache import BuildCache, global_build_cache
from repro_torch.core.space import KernelParams
from repro_torch.core.workload import Workload

_BACKENDS = {"cuda": "cuda", "cpu": "plain"}

# op -> the kernel package whose ops.py answers for it
_PACKAGES = {"matmul": "matmul", "qmatmul": "qmatmul", "gemv": "gemv",
             "vmacc": "vmacc", "attention": "flash_attention"}


@dataclasses.dataclass(frozen=True)
class Family:
    """What the tuner asks a kernel family: the ``FAMILY`` its ``ops.py``
    defines. A new family defines one and joins ``_PACKAGES``."""
    gate: Callable       # (workload, block, hw) -> can the kernel launch it
    footprint: Callable  # (workload, block, hw) -> its launch's shared memory
    build: Callable      # (params, device) -> the schedule as a callable
    reference: Callable  # workload -> the plain oracle
    baseline: Callable   # workload -> the library yardstick
    # (workload, block, hw) -> at most the footprint of every block at least
    # ``block`` in each dim; by default the footprint, if nondecreasing
    floor: Callable | None = None
    # params -> what the launch runs, where the kernel reads less than the
    # params carry (the measuring runner times each key once)
    key: Callable = lambda params: None

    def __post_init__(self):
        if self.floor is None:
            object.__setattr__(self, "floor", self.footprint)


@functools.cache
def family(op: str) -> Family:
    """The kernel family that runs ``op`` (imported on first use)."""
    if op not in _PACKAGES:
        raise ValueError(f"no kernel registered for op {op}")
    return importlib.import_module(
        f"repro_torch.kernels.{_PACKAGES[op]}.ops").FAMILY


def _build_uncached(params: KernelParams, device: str):
    """Build ``params`` for ``device``: a build no cache held (span
    ``kernels.build``)."""
    with tracing.span("kernels.build", op=params.op):
        return family(params.op).build(params, device=device)


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


def launch_key(params: KernelParams):
    """What the launch of ``params`` runs, for an op whose kernel reads less
    than the params carry: qmatmul's (its wgmma loop reads only bn of the
    block, and neither of its loops the order or the accumulate decision).
    None for every other op. The measuring runner times each key once."""
    return family(params.op).key(params)


def reference(workload: Workload):
    """The plain PyTorch oracle for an op family."""
    return family(workload.op).reference(workload)


def baseline(workload: Workload):
    """The library yardstick, the JAX package's ``xla_baseline`` analogue:
    one PyTorch call computing the op in the workload dtype
    (``torch.matmul``, ``torch._int_mm``, ``torch.addcmul``,
    ``scaled_dot_product_attention``). It is timed beside the kernels and
    never fills a kernel slot."""
    return family(workload.op).baseline(workload)


# Each CUDA kernel's name, as ``_build.check`` and the launch counters
# (``launch.<name>`` in :mod:`repro_torch.tracing`) give it, and
# ``_qmm_kernel.wgmma``: those of ``_qmm_kernel``'s launches that took its
# wgmma loop. ``_decode_attention`` (``decode_attention/kernel.py``),
# ``_moe_decode`` (``moe_decode/kernel.py``, a call of its four launches),
# ``_mla_decode`` (``mla_decode/kernel.py``, a call of its two),
# ``_decode_norm`` (``decode_norm/kernel.py``) and ``_decode_rope``
# (``decode_rope/kernel.py``, either mode) are the serving path's own,
# outside the tuner's op families.
KERNEL_NAMES = ("_acc_kernel", "_noacc_kernel", "_qmm_kernel",
                "_qmm_kernel.wgmma", "_gemv_kernel", "_gemv_noacc_kernel",
                "_vmacc_kernel", "_fa_kernel", "_decode_attention",
                "_moe_decode", "_mla_decode", "_decode_norm", "_decode_rope")


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    counted = tracing.counters()
    return {name: counted.get("launch." + name, 0) for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    tracing.reset_counters("launch.")
