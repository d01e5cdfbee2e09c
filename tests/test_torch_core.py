"""The port's core data types and design space against the JAX package.

Workload identity and inputs, schedule JSON, hardware configs, variant
ladders, ``space_for`` / ``concretize`` / static feasibility: on the TPU
configs (``V5E``, ``INTERPRET``) the port must agree with the reference
value for value, so that databases and traces interchange. The H100 config
adds the port's own grain and launch gate, tested here on its own terms.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import intrinsics as ref_intrinsics  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import static_analysis as ref_static  # noqa: E402
from repro.core import workload as ref_W  # noqa: E402
from repro.core.sampler import TraceSampler as RefSampler  # noqa: E402

from repro_torch.core import hardware as hw  # noqa: E402
from repro_torch.core import intrinsics  # noqa: E402
from repro_torch.core import schedule as schedule_lib  # noqa: E402
from repro_torch.core import space  # noqa: E402
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.sampler import TraceSampler  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qmatmul_ops  # noqa: E402

WORKLOADS = [
    ("matmul", (64, 96, 160), "float32"),
    ("matmul", (100, 60, 36), "bfloat16"),
    ("qmatmul", (33, 65, 17), "int8"),
    ("gemv", (128, 512), "float32"),
    ("vmacc", (24, 300), "float32"),
    ("attention", (1, 4, 2, 16, 16, 8), "float32"),
]


def _pair(op, dims, dtype):
    """The same workload in both packages."""
    if op == "qmatmul":
        return ref_W.qmatmul(*dims), W.qmatmul(*dims)
    if op == "attention":
        return ref_W.attention(*dims, dtype), W.attention(*dims, dtype)
    return (getattr(ref_W, op)(*dims, dtype=dtype),
            getattr(W, op)(*dims, dtype=dtype))


@pytest.mark.parametrize("op,dims,dtype", WORKLOADS)
def test_workload_key_and_inputs_match_reference(op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    assert port.key() == ref.key()
    assert port.to_json() == ref.to_json()
    assert (port.flops(), port.min_bytes()) == (ref.flops(), ref.min_bytes())
    for seed in (0, 3):
        for a, b in zip(ref.example_inputs(seed), port.example_inputs(seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_schedule_json_byte_identical():
    # v1: a library-style flat trace; v2: a sampled program trace
    v1 = dict(variant="mxu_128", m_scale=0.25, n_scale=1.0, k_scale=1.0,
              order="mnk", accumulate=False)
    ref_v1 = ref_schedule.Schedule.fixed(**v1)
    port_v1 = schedule_lib.Schedule.fixed(**v1)
    assert json.dumps(port_v1.to_json()) == json.dumps(ref_v1.to_json())
    ref_wl, port_wl = _pair("matmul", (64, 96, 160), "float32")
    ref_v2 = RefSampler(5).sample(ref_space.space_for(ref_wl, ref_hw.V5E))
    port_v2 = TraceSampler(5).sample(space.space_for(port_wl, hw.V5E))
    assert json.dumps(port_v2.to_json()) == json.dumps(ref_v2.to_json())
    for blob in (ref_v1.to_json(), ref_v2.to_json()):
        text = json.dumps(blob)
        assert json.dumps(schedule_lib.Schedule.from_json(
            json.loads(text)).to_json()) == text


def test_tpu_configs_unchanged():
    for name in ("tpu_v5e", "tpu_v5e_vmem32", "tpu_v5e_vmem64",
                 "tpu_v5e_mxu256", "cpu_interpret"):
        assert dataclasses.asdict(hw.get(name)) == \
            dataclasses.asdict(ref_hw.get(name))
        for dtype in ("float32", "bfloat16", "int8"):
            assert hw.get(name).sublane_align(dtype) == \
                ref_hw.get(name).sublane_align(dtype)
            assert hw.get(name).lane_align(dtype) == \
                ref_hw.get(name).lane_align(dtype)


def test_h100_grain_and_registry():
    assert hw.get("h100_sxm") is hw.H100
    assert hw.get("cpu_emulate") is hw.CPU_EMULATE
    # no TPU sublane packing: int8 rows stay on the 16 grain (not 64)
    assert hw.H100.sublane_align("int8") == 16
    assert hw.H100.lane_align("int8") == 32
    assert hw.H100.lane_align("bfloat16") == 16
    assert hw.H100.vmem_budget == 232_448
    assert hw.CPU_EMULATE.sublane_align("int8") == 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_h100_ladder_rungs_are_launchable(dtype):
    rungs = intrinsics.all_variants("matmul", hw.H100, dtype)
    # the register accumulator caps the tile at 128; f32's three ring
    # stages of a 128^3 block need 411,648 bytes of shared memory
    assert rungs[0].block[0] == (64 if dtype == "float32" else 128)
    for v in rungs:
        assert matmul_ops.supports_block_shape(*v.block, dtype,
                                               hw.H100.vmem_capacity)


@pytest.mark.parametrize("name", ["tpu_v5e", "tpu_v5e_vmem32",
                                  "cpu_interpret", "tpu_v5e_mxu256"])
@pytest.mark.parametrize("op,dims,dtype", WORKLOADS)
def test_variant_ladders_match_reference(name, op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    ours = [v.to_json() for v in intrinsics.variants_for(port, hw.get(name))]
    theirs = [v.to_json() for v in
              ref_intrinsics.variants_for(ref, ref_hw.get(name))]
    assert ours == theirs


SPACE_CASES = [("matmul", (64, 96, 160), "float32"),
               ("matmul", (100, 60, 36), "bfloat16"),
               ("qmatmul", (33, 65, 17), "int8"),
               ("qmatmul", (256, 384, 512), "int8")]


@pytest.mark.parametrize("name", ["tpu_v5e", "cpu_interpret"])
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES)
def test_space_and_concretize_match_reference(name, op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    ref_prog = ref_space.space_for(ref, ref_hw.get(name))
    prog = space.space_for(port, hw.get(name))
    assert prog.names() == ref_prog.names()
    ref_traces = list(ref_prog.traces(limit=3000))
    traces = list(prog.traces(limit=3000))
    assert traces == ref_traces
    for t in traces[::7]:
        for ins_name in prog.names():
            assert prog.candidates(ins_name, t) == \
                ref_prog.candidates(ins_name, t)
        ours = space.concretize(port, hw.get(name),
                                schedule_lib.Schedule.fixed(**t))
        theirs = ref_space.concretize(ref, ref_hw.get(name),
                                      ref_schedule.Schedule.fixed(**t))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", ["tpu_v5e", "cpu_interpret"])
@pytest.mark.parametrize("op,dims,dtype", SPACE_CASES[:3])
def test_feasibility_matches_reference(name, op, dims, dtype):
    ref, port = _pair(op, dims, dtype)
    theirs = ref_static.feasibility(ref, ref_hw.get(name))
    ours = static_analysis.feasibility(port, hw.get(name))
    assert (ours.exhaustive, ours.total_traces, ours.valid_traces,
            ours.vmem_floor) == (theirs.exhaustive, theirs.total_traces,
                                 theirs.valid_traces, theirs.vmem_floor)
    assert ours.feasible == theirs.feasible and ours.seen == theirs.seen
    assert [str(d) for d in ours.diagnostics] == \
        [str(d) for d in theirs.diagnostics]


def test_legacy_v1_trace_concretizes_identically():
    for name in ("tpu_v5e", "cpu_interpret"):
        ref, port = _pair("qmatmul", (64, 64, 128), "int8")
        v1 = dict(variant=ref_intrinsics.variants_for(
            ref, ref_hw.get(name))[0].name, m_scale=0.25, n_scale=1.0,
            k_scale=1.0, order="mnk", accumulate=False)
        ours = space.concretize(port, hw.get(name),
                                schedule_lib.Schedule.fixed(**v1))
        theirs = ref_space.concretize(ref, ref_hw.get(name),
                                      ref_schedule.Schedule.fixed(**v1))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("op", ["gemv", "vmacc", "attention"])
def test_unported_ops_have_no_space(op):
    """No op is left unported: gemv, vmacc and (since its kernel was
    ported) attention each have a design space and an exhaustive static
    report, on the TPU and the card's configurations."""
    _, port = _pair(*[c for c in WORKLOADS if c[0] == op][0])
    assert not hasattr(space, "UNPORTED_OPS")
    for config in (hw.V5E, hw.H100):
        assert space.space_for(port, config).traces()
        assert static_analysis.feasibility(port, config).exhaustive


@pytest.mark.parametrize("dims", [(3136, 64, 576), (64, 32000, 576),
                                  (33, 65, 17)])
def test_h100_space_only_offers_launchable_blocks(dims):
    wl = W.qmatmul(*dims)
    report = static_analysis.analyze(wl, hw.H100)
    assert report.exhaustive and report.valid_traces > 0
    prog = space.space_for(wl, hw.H100)
    for t in prog.traces():
        p = space.concretize(wl, hw.H100, schedule_lib.Schedule.fixed(**t))
        ok = qmatmul_ops.supports_block_shape(*p.block,
                                              hw.H100.vmem_capacity)
        assert p.valid == (ok and p.block[0] % 16 == 0
                           and p.block[1] % 32 == 0 and p.block[2] % 32 == 0)
        if p.valid:
            assert p.vmem_bytes == qmatmul_ops.smem_bytes(*p.block)


def test_kernel_gate_rejects_what_the_kernel_cannot_launch():
    limit = hw.H100.vmem_capacity
    gate = matmul_ops.supports_block_shape
    assert gate(128, 128, 64, "float32", limit)
    assert not gate(128, 128, 128, "float32", limit)    # three ring stages
    assert not gate(256, 128, 16, "float32", limit)     # 32768 outputs
    assert not gate(16, 16, 2048, "float32", limit)     # shared memory
    assert gate(16, 16, 2048, "int8", limit)
    assert not gate(16, 32, 30, "int8", limit)          # dp4a depth
    assert not gate(18, 16, 16, "float32", limit)       # mma fragment
    assert matmul_ops.smem_bytes(64, 64, 96, "float32") == \
        3 * (64 * 100 + 96 * 72) * 4
    wl = W.matmul(256, 256, 4096)
    bad = schedule_lib.Schedule.fixed(variant="mxu_64", bm=64, bn=64,
                                      bk=4096, order="mnk", accumulate=True)
    p = space.concretize(wl, hw.H100, bad)
    assert not p.valid
