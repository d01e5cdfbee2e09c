"""Public wrapper of the vmacc kernel, plus its block-shape gate, its
shared-memory footprint and the Python mirror of the launcher's layout
rules (``csrc/vmacc.cu``: ``make_plan``).

The kernel takes the arrays at their real size and masks the tail tiles
itself, so ``build`` pads nothing: one launch per call."""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch import tracing
from repro_torch.core.space import KernelParams
from repro_torch.kernels import Family
from repro_torch.kernels.matmul.ops import TORCH_DTYPES
from repro_torch.kernels.vmacc.ref import vmacc_ref

# csrc/vmacc.cu: THREADS threads a block, each issuing the loads of UNROLL
# 16-byte vectors (or elements) before its first multiply-add; a block
# takes several tiles, but leaves FILL_CTAS (the H100's 132 SMs) blocks
# where there are tiles enough.
THREADS = 256
UNROLL = 4
FILL_CTAS = 132
VECTOR_BYTES = 16
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def supports_block_shape(br: int, bc: int, sub: int, lane: int) -> bool:
    """Can the vmacc kernel take a (br, bc) block?

    The reference's rule (its ``vmacc/ops.py``): a positive block whose rows
    are a sublane multiple and whose columns are a lane multiple. The CUDA
    kernel adds no limit of its own: its blocks walk tiles of any size
    (``csrc/vmacc.cu``), holding nothing in shared memory.
    """
    if br < 1 or bc < 1:
        return False
    return br % sub == 0 and bc % lane == 0


def smem_bytes(br: int, bc: int, dtype: str) -> int:
    """Shared memory one block asks for: none (an elementwise tile has no
    reuse; the kernel works in registers). Constant, so nondecreasing in
    each block dim."""
    del br, bc, dtype
    return 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-time layout ``make_plan`` in ``csrc/vmacc.cu`` computes."""
    v: int        # elements a step: 16 bytes of them, or 1
    gc: int       # tiles across the columns
    tiles: int
    per: int      # tiles a block takes, stacked in one column of tiles
    blocks: int


def plan(r: int, c: int, br: int, bc: int, dtype: str,
         aligned: bool = True) -> Plan:
    """The kernel's layout for real ``(r, c)`` at block ``(br, bc)``
    (``aligned``: all four arrays start on 16 bytes): the rules of
    ``csrc/vmacc.cu``'s ``make_plan``, step for step."""
    vec = VECTOR_BYTES // _ITEMSIZE[dtype]
    v = vec if aligned and c % vec == 0 and bc % vec == 0 else 1
    gc, gr = -(-c // bc), -(-r // br)
    tiles = gr * gc
    per = max(1, min(THREADS * UNROLL // (br * bc // v), tiles // FILL_CTAS))
    return Plan(v=v, gc=gc, tiles=tiles, per=per, blocks=-(-gr // per) * gc)


_MANGLED = re.compile(r"vmacc_kernelI(f|13__nv_bfloat16)Li(\d+)E")


def kernel_label(mangled: str) -> str | None:
    """``vmacc_kernel<dtype,V>`` for the mangled name of one of
    ``csrc/vmacc.cu``'s kernels, else None."""
    m = _MANGLED.search(mangled)
    if m is None:
        return None
    dtype = "float32" if m[1] == "f" else "bfloat16"
    return f"vmacc_kernel<{dtype},{m[2]}>"


def build(params: KernelParams, device: str = "cuda"):
    """``f(a, b, c) -> a * b + c`` for this schedule, on ``device``: inputs
    (numpy arrays or tensors) are moved there, cast to the workload dtype
    and handed to the kernel at their real size. Inputs that are already
    contiguous on the device in that dtype are not copied."""
    from repro_torch.kernels.vmacc.kernel import vmacc_ragged

    compute = TORCH_DTYPES[params.dtype]

    def f(a, b, cc):
        with tracing.span("vmacc.call"):
            a, b, cc = (torch.as_tensor(t, device=device).to(compute)
                        .contiguous() for t in (a, b, cc))
            return vmacc_ragged(a, b, cc, params.block)

    return f


# The family's answers to the tuner (``kernels.family``).
FAMILY = Family(
    gate=lambda wl, block, hw: supports_block_shape(
        *block, hw.sublane_align(wl.dtype), hw.lane_align(wl.dtype)),
    footprint=lambda wl, block, hw: smem_bytes(*block, wl.dtype),
    build=build, reference=lambda wl: vmacc_ref,
    baseline=lambda wl: lambda a, b, c: torch.addcmul(c, a, b))
