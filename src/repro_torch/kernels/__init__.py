"""CUDA kernels of the port, with the build/reference/baseline dispatch the
tuner uses.

Each kernel package has:
  kernel.py — the wrapper that launches the CUDA kernel (``csrc/*.cu``) on
              a CUDA tensor, or runs the plain version on a CPU tensor,
  plain.py  — the plain PyTorch version: the Pallas grid's per-block loop,
  ops.py    — the public wrapper (dtype policy; padding to the block
              where the kernel needs it: the qmatmul and vmacc kernels
              mask their tail tiles and take no padding) and the kernel's
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
``torch._int_mm``, ``torch.addcmul``,
``scaled_dot_product_attention``). It is timed beside the kernels and
never fills a kernel slot.
"""

from __future__ import annotations

import functools
import math

from repro_torch import tracing
from repro_torch.core.build_cache import BuildCache, global_build_cache
from repro_torch.core.space import KernelParams
from repro_torch.core.workload import Workload

_BACKENDS = {"cuda": "cuda", "cpu": "plain"}


def _build_uncached(params: KernelParams, device: str):
    """Build ``params`` for ``device``: a build no cache held (span
    ``kernels.build``)."""
    with tracing.span("kernels.build", op=params.op):
        if params.op == "matmul":
            from repro_torch.kernels.matmul import ops
            return ops.build(params, device=device)
        if params.op == "qmatmul":
            from repro_torch.kernels.qmatmul import ops
            return ops.build(params, device=device)
        if params.op == "gemv":
            from repro_torch.kernels.gemv import ops
            return ops.build(params, device=device)
        if params.op == "vmacc":
            from repro_torch.kernels.vmacc import ops
            return ops.build(params, device=device)
        if params.op == "attention":
            from repro_torch.kernels.flash_attention import ops
            return ops.build(params, device=device)
        raise ValueError(f"no kernel registered for op {params.op}")


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
    than the params carry: qmatmul's (``qmatmul.ops.launch_key``: its wgmma
    loop reads only bn of the block, and neither of its loops the order or
    the accumulate decision). None for every other op. The measuring runner
    times each key once."""
    if params.op == "qmatmul":
        from repro_torch.kernels.qmatmul import ops
        return ops.launch_key(*params.dims, *params.block)
    return None


def reference(workload: Workload):
    """The plain PyTorch oracle for an op family."""
    if workload.op == "matmul":
        from repro_torch.kernels.matmul.ref import matmul_ref
        return matmul_ref
    if workload.op == "qmatmul":
        from repro_torch.kernels.qmatmul.ref import qmatmul_ref
        return qmatmul_ref
    if workload.op == "gemv":
        from repro_torch.kernels.gemv.ref import gemv_ref
        return gemv_ref
    if workload.op == "vmacc":
        from repro_torch.kernels.vmacc.ref import vmacc_ref
        return vmacc_ref
    if workload.op == "attention":
        from repro_torch.kernels.flash_attention.ref import attention_ref
        return functools.partial(attention_ref,
                                 causal="causal" in workload.tags)
    raise ValueError(f"no reference for op {workload.op}")


def baseline(workload: Workload):
    """One PyTorch library call computing the op in the workload dtype —
    the yardstick the tuned kernels are compared with (``torch.matmul``;
    ``torch._int_mm`` for int8, plus the requantization for qmatmul;
    ``torch.matmul`` with a float32 result for gemv, as the kernels return;
    ``torch.addcmul`` for vmacc; ``scaled_dot_product_attention`` for
    attention)."""
    import torch

    from repro_torch.kernels.matmul.ops import TORCH_DTYPES

    if workload.op == "matmul":
        dtype = TORCH_DTYPES[workload.dtype]
        if dtype == torch.int8:
            return _int_mm
        return lambda x, w: torch.matmul(x.to(dtype), w.to(dtype))
    if workload.op == "qmatmul":
        from repro_torch.kernels.qmatmul.ops import DEFAULT_SCALE
        from repro_torch.kernels.qmatmul.plain import requantize

        return lambda x, w, bias: requantize(_int_mm(x, w), bias[None, :],
                                             DEFAULT_SCALE)
    if workload.op == "gemv":
        dtype = TORCH_DTYPES[workload.dtype]
        return lambda x, w: torch.matmul(x.to(dtype), w.to(dtype)).float()
    if workload.op == "vmacc":
        return lambda a, b, c: torch.addcmul(c, a, b)
    if workload.op == "attention":
        return functools.partial(_sdpa, dtype=TORCH_DTYPES[workload.dtype],
                                 causal="causal" in workload.tags)
    raise ValueError(f"no baseline for op {workload.op}")


def _sdpa(q, k, v, dtype, causal):
    """``scaled_dot_product_attention`` with the oracle's semantics: scale
    1/sqrt(d), grouped KV heads, and the causal mask aligned to the bottom
    right. SDPA's ``is_causal`` aligns it to the top left, which is the same
    only when q and kv have one length; otherwise the call adds the
    oracle's -1e30 to the masked scores (a boolean mask would give a row
    with no visible key zeros, where the oracle averages every v row)."""
    import torch

    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lq, lkv, d = q.shape[2], k.shape[2], q.shape[3]
    mask = None
    if causal and lq != lkv:
        visible = torch.ones((lq, lkv), dtype=torch.bool,
                             device=q.device).tril(diagonal=lkv - lq)
        mask = torch.zeros((lq, lkv), dtype=dtype,
                           device=q.device).masked_fill(~visible, -1e30)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and lq == lkv,
        scale=1.0 / math.sqrt(d), enable_gqa=True)


# (rows, k, n, device type) -> the padded shape ``torch._int_mm`` is called
# at for it (the shape itself when it takes it).
_INT_MM_SHAPES: dict[tuple, tuple[int, int, int]] = {}


def _int_mm(x, w):
    """``torch._int_mm(x, w)`` for any shape. On the card it takes only
    more than 16 rows and k and n multiples of 8, and cuBLASLt refuses some
    shapes within those limits too (``CUBLAS_STATUS_NOT_SUPPORTED`` for
    MobileNetV2's 784 x 144 x 24, and for it padded to 784 x 144 x 32). The
    call tries the shape itself, then zero-padded to multiples of 16, then
    of 128, and remembers per shape the first one that runs."""
    m, k = x.shape
    n = w.shape[1]
    key = (m, k, n, x.device.type)
    if key in _INT_MM_SHAPES:
        return _int_mm_at(x, w, _INT_MM_SHAPES[key])
    tries = [(m, k, n)] + [tuple(d + (-d) % g for d in (max(m, 17), k, n))
                           for g in (16, 128)]
    for i, shape in enumerate(tries):
        try:
            out = _int_mm_at(x, w, shape)
        except RuntimeError:
            if i == len(tries) - 1:
                raise
            continue
        _INT_MM_SHAPES[key] = shape
        return out


def _int_mm_at(x, w, shape):
    """``x @ w`` in int32 through ``torch._int_mm`` at ``shape`` (pm, pk,
    pn), zero-padding the operands up to it and slicing the result back."""
    import torch

    m, k = x.shape
    n = w.shape[1]
    pm, pk, pn = shape
    if shape == (m, k, n):
        return torch._int_mm(x, w)
    xp = torch.nn.functional.pad(x, (0, pk - k, 0, pm - m))
    wp = torch.nn.functional.pad(w, (0, pn - n, 0, pk - k))
    return torch._int_mm(xp, wp)[:m, :n]


# Each CUDA kernel's name, as ``_build.check`` and the launch counters
# (``launch.<name>`` in :mod:`repro_torch.tracing`) give it, and
# ``_qmm_kernel.wgmma``: those of ``_qmm_kernel``'s launches that took its
# wgmma loop. ``_decode_attention`` (``decode_attention/kernel.py``) is the
# serving path's own, outside the tuner's op families.
KERNEL_NAMES = ("_acc_kernel", "_noacc_kernel", "_qmm_kernel",
                "_qmm_kernel.wgmma", "_gemv_kernel", "_gemv_noacc_kernel",
                "_vmacc_kernel", "_fa_kernel", "_decode_attention")


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    counted = tracing.counters()
    return {name: counted.get("launch." + name, 0) for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    tracing.reset_counters("launch.")
