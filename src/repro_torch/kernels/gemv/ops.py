"""Public wrapper of the GEMV kernels: pad -> kernel -> slice, per a
schedule, plus the kernels' block-shape gate, their shared-memory footprint
and the Python mirror of the launcher's layout rules (``csrc/gemv.cu``)."""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch import tracing
from repro_torch.core.space import KernelParams
from repro_torch.kernels import Family
from repro_torch.kernels.gemv.ref import gemv_ref
from repro_torch.kernels.matmul.ops import TORCH_DTYPES, pad2

# csrc/gemv.cu: a block always has THREADS threads; each issues
# ROWS_IN_FLIGHT loads of w before its first FMA; _gemv_kernel splits K
# over a cluster of at most MAX_CLUSTER blocks while the grid has fewer
# than FILL_CTAS (the H100's 132 SMs) blocks. A block's threads cover at
# most THREADS 16-byte vectors of columns, 1024 f32 columns: MAX_BN, for
# both dtypes.
THREADS = 256
ROWS_IN_FLIGHT = 8
MAX_CLUSTER = 8
FILL_CTAS = 132
VECTOR_BYTES = 16
MAX_BN = 1024
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def supports_block_shape(bn: int, bk: int, lane: int) -> bool:
    """Can the GEMV kernels take a (bn, bk) block?

    The reference's rule (its ``gemv/ops.py``): ``bk`` a positive lane
    multiple, ``bn`` a lane multiple (a full output tile per step) or
    exactly 1 (the paper's J = 1 row kernel). The CUDA kernel adds two
    limits of its own: ``bn <= MAX_BN``, and ``bn`` a multiple of its
    16-byte vector width (8 bf16, 4 f32) unless it is 1, which every lane
    multiple of 8 is (the H100's lane is 16). On the TPU configs neither
    binds (their ``bn`` candidates stop at 8 lanes, 1024), so their design
    spaces stay the reference's.
    """
    if bn < 1 or bk < 1:
        return False
    if bk % lane:
        return False
    return (bn == 1 or bn % lane == 0) and bn <= MAX_BN


def vector_width(bn: int, dtype: str) -> int:
    """Columns a thread reads with one load: 16 bytes of them, or one
    element for the J = 1 row kernel (rows of odd width are not 16-byte
    aligned)."""
    return 1 if bn == 1 else VECTOR_BYTES // _ITEMSIZE[dtype]


def smem_bytes(bn: int, bk: int, dtype: str) -> int:
    """Dynamic shared memory the launcher asks for: two reduction buffers
    of ``THREADS * vector_width`` floats. Nondecreasing in ``bn`` and
    ``bk`` (the static analyzer's floor relies on it)."""
    del bk
    return 2 * THREADS * vector_width(bn, dtype) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-time layout ``make_plan`` in ``csrc/gemv.cu`` computes."""
    ct: int        # threads across the columns
    rt: int        # thread rows
    s: int         # lanes that sum one column
    g: int         # k steps per wave
    rg: int        # thread rows per step
    span: int      # rows of one step
    steps: int     # steps in all
    waves: int
    nbatch: int    # batches of ROWS_IN_FLIGHT rows per thread and wave
    cluster: int   # blocks per cluster


def plan(pn: int, pk: int, bn: int, bk: int, dtype: str, accumulate: bool,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The kernel's layout for padded ``(pn, pk)`` at block ``(bn, bk)``:
    the rules stated in ``csrc/gemv.cu``'s header, step for step
    (``max_cluster`` as ``gemv_launch_capped`` takes it)."""
    v = vector_width(bn, dtype)
    ct = bn // v
    rt = THREADS // ct
    s = 1
    while s < 32 and s * 2 * bn <= THREADS:
        s *= 2
    if accumulate:
        c = 1
        while (c < max_cluster and (pn // bn) * c < FILL_CTAS
               and pk // c > ROWS_IN_FLIGHT * rt and pk % (2 * c) == 0):
            c *= 2
        cluster, span, steps, g = c, pk // c, 1, 1
    else:
        cluster, span, steps = 1, bk, pk // bk
        g = max(1, min(rt * ROWS_IN_FLIGHT // bk, min(steps, rt)))
    rg = rt // g
    return Plan(ct=ct, rt=rt, s=s, g=g, rg=rg, span=span, steps=steps,
                waves=-(-steps // g),
                nbatch=-(-span // (ROWS_IN_FLIGHT * rg)), cluster=cluster)


_MANGLED = re.compile(r"gemv_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E")
# A 128-bit global load in SASS, whatever its cache and scope suffixes
# (LDG.E.128, LDG.E.NA.128.CONSTANT, ...).
LDG_128 = re.compile(r"\bLDG\.E(?:\.[A-Z0-9_]+)*\.128\b")


def kernel_label(mangled: str) -> str | None:
    """``gemv_kernel<dtype, V, acc|noacc>`` for the mangled name of one of
    ``csrc/gemv.cu``'s kernels, else None."""
    m = _MANGLED.search(mangled)
    if m is None:
        return None
    dtype = "float32" if m[1] == "f" else "bfloat16"
    return f"gemv_kernel<{dtype},{m[2]},{'acc' if m[3] == '1' else 'noacc'}>"


def build(params: KernelParams, device: str = "cuda"):
    """``f(x, w) -> x @ w`` for this schedule, on ``device``: inputs (numpy
    arrays or tensors) are moved there and cast to the workload dtype,
    padded, multiplied by the kernel and sliced to ``(1, n)``. The result
    is float32 whatever the workload dtype, as the reference's."""
    from repro_torch.kernels.gemv.kernel import gemv_blocked

    n, _k = params.dims
    pn, pk = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def f(x, w):
        with tracing.span("gemv.call"):
            x = pad2(torch.as_tensor(x, device=device).to(compute), 1, pk)
            w = pad2(torch.as_tensor(w, device=device).to(compute), pk, pn)
            out = gemv_blocked(x.contiguous(), w.contiguous(), params.block,
                               params.accumulate)
            return out[:, :n]

    return f


def baseline(workload):
    """``torch.matmul`` in the workload dtype, its result in float32 as
    the kernels return it."""
    dtype = TORCH_DTYPES[workload.dtype]
    return lambda x, w: torch.matmul(x.to(dtype), w.to(dtype)).float()


# The family's answers to the tuner (``kernels.family``).
FAMILY = Family(
    gate=lambda wl, block, hw: supports_block_shape(
        *block, hw.lane_align(wl.dtype)),
    footprint=lambda wl, block, hw: smem_bytes(*block, wl.dtype),
    build=build, reference=lambda wl: gemv_ref, baseline=baseline)
