"""The copied bound arithmetic gives the bounds PERF.md's table of kernels
holds, and the input rules keep the requantized outputs off the clip."""

import math

import pytest

import torch

from portbench import harness, inputs, roofline
from portbench.reference import qmatmul


def test_w2_bound_from_bytes():
    # W2, MobileLLM-125M's int8 LM head: 6.163 us, bound by bytes
    dims = (64, 32000, 576)
    t_bytes = qmatmul.op_bytes(dims, "int8") \
        / roofline.HBM_BYTES_PER_S
    assert roofline.bound_s("qmatmul", dims, "int8") == t_bytes
    assert round(t_bytes * 1e6, 3) == 6.163


def test_vmacc_bound():
    assert round(roofline.bound_s("vmacc", (12544, 32), "float32") * 1e6,
                 3) == 1.917


def test_compute_bound_at_peak():
    # a large square int8 matmul is bound by its operations
    dims = (8192, 8192, 8192)
    assert roofline.bound_s("qmatmul", dims, "int8") == pytest.approx(
        2 * 8192 ** 3 / 1979e12)


@pytest.mark.parametrize("k", [27, 96, 576, 1152, 4608])
def test_operand_range_spreads_outputs(k):
    a = qmatmul.operand_range(k, 30, 0.01)
    std = 0.01 * math.sqrt(k) * a * (a + 1) / 3
    assert 20 < std < 45


def test_unique_and_expand():
    config = {"ops": [{"count": 2, "op": "qmatmul", "dims": [4, 8, 16],
                       "dtype": "int8"},
                      {"count": 3, "op": "vmacc", "dims": [4, 8],
                       "dtype": "float32"},
                      {"count": 1, "op": "qmatmul", "dims": [4, 8, 16],
                       "dtype": "int8"}]}
    assert len(inputs.expand(config)) == 6
    assert [(o["op"], o["count"]) for o in inputs.unique(config)] == [
        ("qmatmul", 3), ("vmacc", 3)]


L2_BYTES = 50e6


def test_rotation_draws_distinct_sets_from_the_seed():
    config = {"assumed": {"requant_scale": 0.01, "qmatmul_out_std": 30,
                          "qmatmul_bias_range": 1000, "vmacc_std": 0.5},
              "ops": [{"count": 2, "op": "qmatmul", "dims": [8, 16, 32],
                       "dtype": "int8"},
                      {"count": 1, "op": "vmacc", "dims": [4, 8],
                       "dtype": "float32"}]}
    one = inputs.pass_bytes(config)
    assert inputs.operand_sets(config, 0) == 1
    assert inputs.operand_sets(config, 2.5 * one) == 3
    sets = inputs.rotation(config, 2**31 + 11, "cpu", 2.5 * one)
    first = inputs.for_launches(config, 2**31 + 11, "cpu")
    assert len(sets) == 3
    for a, b in zip(sets[0], first):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(sets[0][0][0], sets[1][0][0])


@pytest.mark.parametrize(
    "cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_operands_cycle_past_the_l2(cell):
    found = harness.find_cell(harness.load_manifest(), cell)
    need = found.traffic["rotate_bytes"]
    assert need >= 2 * L2_BYTES
    sets = inputs.operand_sets(found.config, need)
    assert sets * inputs.pass_bytes(found.config) >= need
