"""Public wrapper of the flash-attention kernel: cast -> reshape -> pad ->
kernel -> slice, per a schedule, plus the kernel's block-shape gate, its
shared-memory footprint and the Python mirror of its launch layout
(``csrc/flash_attention.cu``: ``fa_plan``)."""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F

from repro_torch.core.space import KernelParams
from repro_torch.core.workload import dtype_bytes
from repro_torch.kernels.matmul.ops import TORCH_DTYPES

# csrc/flash_attention.cu: one warp per 16 query rows (one mma m16), a
# FA_STAGES-deep cp.async ring of k and v tiles, shared rows padded by
# FA_ROW_PAD bytes; a block splits each KV tile's columns over warps while
# it has fewer than FA_MIN_WARPS; bq at most FA_MAX_BQ (8 warps), the head
# dim at most FA_MAX_PD, bq, bkv and pd multiples of FA_FRAG.
FA_FRAG = 16
FA_STAGES = 2
FA_ROW_PAD = 16
FA_MIN_WARPS = 4
FA_MAX_BQ = 128
FA_MAX_PD = 256


def smem_bytes(bq: int, bkv: int, pd: int, dtype: str) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu:
    fa_smem_bytes): the q tile and FA_STAGES stages of a k and a v tile, in
    the input dtype, every row padded by FA_ROW_PAD bytes. Nondecreasing in
    each of bq, bkv and pd (the static analyzer relies on it)."""
    return (bq + 2 * FA_STAGES * bkv) * (pd * dtype_bytes(dtype) + FA_ROW_PAD)


def supports_block_shape(bq: int, bkv: int, pd: int, dtype: str,
                         smem_limit: int) -> bool:
    """Can the CUDA kernel launch a (bq, bkv) block at padded head dim
    ``pd``? bq, bkv and pd are multiples of the 16-row mma fragment, bq at
    most 128 (8 warps), pd at most 256 (the largest register class of the
    accumulator), the dtype f32 or bf16, and the block's shared memory
    (``smem_bytes``) fits ``smem_limit`` bytes."""
    if dtype not in ("float32", "bfloat16") or min(bq, bkv, pd) < FA_FRAG:
        return False
    if bq % FA_FRAG or bkv % FA_FRAG or pd % FA_FRAG:
        return False
    if bq > FA_MAX_BQ or pd > FA_MAX_PD:
        return False
    return smem_bytes(bq, bkv, pd, dtype) <= smem_limit


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-time layout ``fa_plan`` in ``csrc/flash_attention.cu``
    computes."""
    wq: int        # warps down the query rows (bq / 16)
    wk: int        # warps across each KV tile's columns
    warps: int
    cols: int      # KV columns per warp
    dclass: int    # register class of the head dim (64, 128 or 256)
    sub: int       # key columns per sub-tile (64, 32 or 16, dividing cols)
    exact: bool    # the instantiation without head-dim predicates (pd 64)


def plan(bq: int, bkv: int, pd: int) -> Plan:
    """The kernel's layout for a (bq, bkv) block at padded head dim ``pd``:
    the rules of ``fa_plan``, step for step."""
    wq, wk = bq // FA_FRAG, 1
    while (bkv // FA_FRAG) % (2 * wk) == 0 and wq * wk * 2 <= FA_MIN_WARPS:
        wk *= 2
    dclass = 64 if pd <= 64 else 128 if pd <= 128 else 256
    cols = bkv // wk
    sub = 64 if cols % 64 == 0 and dclass != 256 else \
        32 if cols % 32 == 0 else 16
    return Plan(wq=wq, wk=wk, warps=wq * wk, cols=cols, dclass=dclass,
                sub=sub, exact=pd == 64)


_MANGLED = re.compile(
    r"fa_tc_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E")
# Any tensor-core product in SASS; the f32 kernels must show the TF32 one
# (kernels.matmul.ops.HMMA_TF32).
HMMA = re.compile(r"\bHMMA\.")


def kernel_label(mangled: str) -> str | None:
    """``fa_tc_kernel<f32|bf16,DC,SUBT,exact|any>`` for the mangled name of
    one of ``csrc/flash_attention.cu``'s kernels, else None."""
    m = _MANGLED.search(mangled)
    if m is None:
        return None
    return (f"fa_tc_kernel<{'f32' if m[1] == 'f' else 'bf16'},{m[2]},{m[3]},"
            f"{'exact' if m[4] == '1' else 'any'}>")


def kernel_labels() -> list[str]:
    """Every instantiation ``fa_launch`` can pick: per dtype, head-dim class
    64 (exact and not) with sub-tiles of 8, 4 and 2 key tiles, 128 with
    8, 4 and 2, 256 with 4 and 2."""
    return [f"fa_tc_kernel<{t},{dc},{sub},{kind}>"
            for t in ("f32", "bf16")
            for dc, kinds, subs in ((64, ("exact", "any"), (8, 4, 2)),
                                    (128, ("any",), (8, 4, 2)),
                                    (256, ("any",), (4, 2)))
            for kind in kinds for sub in subs]


def pad_operands(params: KernelParams, q, k, v, device: str = "cuda"):
    """q (B, Hq, Lq, D) and k, v (B, Hkv, Lkv, D) (numpy arrays or tensors)
    as the kernel takes them: on ``device``, in the workload dtype,
    flattened to (B*H, L, D) and zero-padded to ``params.padded_dims``."""
    b, hq, hkv, lq, lkv, d = params.dims
    _, _, _, pq, pkv, pd = params.padded_dims
    compute = TORCH_DTYPES[params.dtype]

    def prep(t, heads, length, padded):
        t = torch.as_tensor(t, device=device).to(compute)
        t = t.reshape(b * heads, length, d)
        if padded != length or pd != d:
            t = F.pad(t, (0, pd - d, 0, padded - length))
        return t.contiguous()

    return prep(q, hq, lq, pq), prep(k, hkv, lkv, pkv), prep(v, hkv, lkv, pkv)


def build(params: KernelParams, device: str = "cuda"):
    """``f(q, k, v) -> attention`` for this schedule, on ``device``: the
    operands are padded (:func:`pad_operands`), run through the kernel,
    sliced and reshaped back to (B, Hq, Lq, D). The output is in the
    workload dtype, as the reference's."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_blocked

    b, hq, _, lq, _, d = params.dims

    def f(q, k, v):
        o = flash_attention_blocked(*pad_operands(params, q, k, v, device),
                                    params)
        return o[:, :lq, :d].reshape(b, hq, lq, d)

    return f
