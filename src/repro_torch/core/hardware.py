"""Hardware configurations — the analogue of the paper's VLEN parameter.

The paper tunes the same workload on FPGA SoCs with VLEN in {256, 512, 1024}
bits and shows hand-written kernels degrade across configs while tuned
schedules adapt. A :class:`HardwareConfig` captures the parameters that play
the same role: on-chip memory and compute-unit geometry bound the block
sizes (as VLEN bounds VL), while peak rates feed the analytic runner.

The TPU configurations are kept value for value, so that database keys
written by the JAX package (``<workload>@tpu_v5e``) resolve here and the
design spaces on them agree with the reference. The port's own target is
:data:`H100`, a :class:`CudaHardwareConfig`: the same fields read for an
NVIDIA Hopper card, plus the tile grain of the port's CUDA kernels.
"""

from __future__ import annotations

import dataclasses

GiB = 1024**3
MiB = 1024**2


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Parameters of one accelerator configuration (the "VLEN" of this work)."""

    name: str
    # Peak compute, FLOP/s per chip, by compute dtype.
    peak_flops_bf16: float
    peak_flops_f32: float
    peak_flops_int8: float
    # Memory system.
    hbm_bandwidth: float  # bytes/s
    hbm_capacity: int  # bytes
    vmem_capacity: int  # bytes  (bounds the block working set, like VLEN)
    # Interconnect (per-link, one direction).
    ici_bandwidth: float  # bytes/s
    # Fraction of VMEM a kernel's block working set may occupy. The rest is
    # headroom for compiler-managed spills, semaphores, and double-buffering
    # slack the footprint model doesn't count. This is the one authoritative
    # bound shared by the dynamic postprocessor (``postproc_vmem_fit``) and
    # the static feasibility analyzer (``core/static_analysis.py``) — tuning
    # it per part (or per compiler release) must move both in lockstep.
    vmem_headroom: float = 0.9
    # Compute unit geometry.
    mxu_dim: int = 128  # systolic array is mxu_dim x mxu_dim
    vpu_lanes: int = 128
    vpu_sublanes: int = 8
    # Fixed overhead charged per Pallas grid step by the analytic model
    # (instruction issue + DMA setup); exposes the paper's "too-small VL is
    # not worth vectorizing" effect (they stop at VL=4, we stop at one tile).
    grid_step_overhead_s: float = 1.5e-6

    @property
    def vmem_budget(self) -> float:
        """Usable VMEM bytes for a block working set (capacity x headroom) —
        the single bound both validation paths compare footprints against."""
        return self.vmem_capacity * self.vmem_headroom

    def peak_flops(self, dtype: str) -> float:
        if dtype in ("int8", "uint8"):
            return self.peak_flops_int8
        if dtype in ("bfloat16", "float16"):
            return self.peak_flops_bf16
        return self.peak_flops_f32

    def sublane_align(self, dtype: str) -> int:
        """Minimum tile size in the second-to-last dim for this dtype."""
        packing = {"float32": 1, "bfloat16": 2, "float16": 2, "int8": 4,
                   "uint8": 4, "int32": 1}.get(dtype, 1)
        return self.vpu_sublanes * packing

    def lane_align(self, dtype: str) -> int:  # last-dim tile multiple
        del dtype
        return self.vpu_lanes


@dataclasses.dataclass(frozen=True)
class CudaHardwareConfig(HardwareConfig):
    """A configuration whose candidates run on the port's CUDA kernels.

    The inherited fields keep their names (the design-space program, the
    cost model and the analytic runner read them) and mean on Hopper:

    - ``vmem_capacity``: the shared memory one thread block may opt into
      (232,448 bytes on an H100). Block footprints are the kernels' exact
      shared-memory bytes, so ``vmem_headroom`` is 1.0;
    - ``mxu_dim``: 64, the M of one warpgroup ``wgmma``;
    - ``vpu_sublanes`` / ``vpu_lanes``: the tensor-core tile grain, 16 rows
      and 16 columns; ``int8_k_grain`` (32) replaces ``vpu_lanes`` for int8
      operands, whose ``wgmma`` depth is 32 bytes;
    - ``hbm_*``: device memory; ``ici_bandwidth``: NVLink, one direction.

    Registration is via :data:`H100`; :func:`check_device` holds the
    values read from the card against it. ``on_card`` is False for
    :data:`CPU_EMULATE`, which shares the H100's design space but runs the
    kernels' plain versions on the host.
    """

    int8_k_grain: int = 32
    sm_count: int = 132
    on_card: bool = True

    def sublane_align(self, dtype: str) -> int:
        # No TPU-style sublane packing: an int8 row tile is 16 rows like any
        # other (packing would force bm % 64 for no reason on this card).
        del dtype
        return self.vpu_sublanes

    def lane_align(self, dtype: str) -> int:
        if dtype in ("int8", "uint8"):
            return self.int8_k_grain
        return self.vpu_lanes


# TPU v5e — the production target (constants fixed by the assignment).
V5E = HardwareConfig(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    peak_flops_f32=98.5e12,
    peak_flops_int8=394e12,
    hbm_bandwidth=819e9,
    hbm_capacity=16 * GiB,
    vmem_capacity=128 * MiB,
    ici_bandwidth=50e9,
)

# The "VLEN sweep" analogue: same chip family, different on-chip memory /
# compute-unit geometry. The paper's Figure 4 experiment re-tunes per config.
V5E_VMEM32 = dataclasses.replace(V5E, name="tpu_v5e_vmem32", vmem_capacity=32 * MiB)
V5E_VMEM64 = dataclasses.replace(V5E, name="tpu_v5e_vmem64", vmem_capacity=64 * MiB)
V5E_MXU256 = dataclasses.replace(
    V5E, name="tpu_v5e_mxu256", mxu_dim=256,
    peak_flops_bf16=4 * 197e12, peak_flops_f32=4 * 98.5e12,
    peak_flops_int8=4 * 394e12,
)

# CPU-interpret "hardware" of the JAX package's InterpretRunner. Kept so
# that records it wrote resolve here.
INTERPRET = HardwareConfig(
    name="cpu_interpret",
    peak_flops_bf16=1e11,
    peak_flops_f32=1e11,
    peak_flops_int8=1e11,
    hbm_bandwidth=20e9,
    hbm_capacity=8 * GiB,
    vmem_capacity=128 * MiB,
    ici_bandwidth=1e9,
    mxu_dim=8,
    vpu_lanes=8,
    vpu_sublanes=1,
    grid_step_overhead_s=50e-6,
)

# NVIDIA H100 SXM (data sheet, dense rates; hopper white paper for the
# per-block shared-memory limit). f32 is the data sheet's non-tensor-core
# rate, kept as the cost model's f32 figure; the port's f32 matmul and
# attention kernels run on the tensor cores as 3xTF32 (three TF32 products
# per f32 product at the dense TF32 rate of 494.7 TFLOP/s).
H100 = CudaHardwareConfig(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    peak_flops_int8=1979e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80 * 10**9,
    vmem_capacity=232_448,
    ici_bandwidth=450e9,
    vmem_headroom=1.0,
    mxu_dim=64,
    vpu_lanes=16,
    vpu_sublanes=16,
)

# The host CPU running the kernels' plain PyTorch versions (EmulateRunner):
# the H100's design space and tile rules, the host's rates. The analogue of
# INTERPRET for the port.
CPU_EMULATE = dataclasses.replace(
    H100, name="cpu_emulate",
    peak_flops_bf16=1e11, peak_flops_f32=1e11, peak_flops_int8=1e11,
    hbm_bandwidth=20e9, hbm_capacity=8 * GiB, ici_bandwidth=1e9,
    grid_step_overhead_s=50e-6, on_card=False,
)

SWEEP = (V5E_VMEM32, V5E_VMEM64, V5E)

_REGISTRY = {hw.name: hw for hw in (V5E, V5E_VMEM32, V5E_VMEM64, V5E_MXU256,
                                    INTERPRET, H100, CPU_EMULATE)}


def get(name: str) -> HardwareConfig:
    return _REGISTRY[name]


def on_card(hw: HardwareConfig) -> bool:
    """Whether candidates on ``hw`` are measured on a CUDA card."""
    return isinstance(hw, CudaHardwareConfig) and hw.on_card


def check_device(hw: CudaHardwareConfig, device: int = 0) -> None:
    """Raise unless the card at ``device`` has the SM count and per-block
    shared-memory limit ``hw`` was written for (the design space and the
    kernels' launch gates are derived from both)."""
    import torch

    props = torch.cuda.get_device_properties(device)
    smem = props.shared_memory_per_block_optin
    if props.multi_processor_count != hw.sm_count or smem != hw.vmem_capacity:
        raise RuntimeError(
            f"{props.name}: {props.multi_processor_count} SMs and {smem} B "
            f"shared memory per block, but {hw.name} assumes {hw.sm_count} "
            f"and {hw.vmem_capacity}")
