"""The plain reference against the port's plain versions on small CPU
shapes, and the control at a size a test run holds: the program's readings
stay under each limit and the control's go over one."""

import pytest
import torch

from portbench import check, harness, inputs
from portbench.reference import qmatmul, vmacc
from repro_torch.kernels.qmatmul.plain import qmatmul_plain
from repro_torch.kernels.vmacc.plain import vmacc_plain

ASSUMED = {"requant_scale": 0.01, "qmatmul_out_std": 30,
           "qmatmul_bias_range": 1000, "vmacc_std": 0.5}
LIMITS = {qmatmul.NUMBER: qmatmul.LIMIT, vmacc.NUMBER: vmacc.LIMIT}
SMALL = {"name": "small", "assumed": ASSUMED, "ops": [
    {"count": 1, "op": "qmatmul", "dims": [48, 32, 27], "dtype": "int8"},
    {"count": 2, "op": "qmatmul", "dims": [16, 64, 576], "dtype": "int8"},
    {"count": 1, "op": "qmatmul", "dims": [1, 40, 1280], "dtype": "int8"},
    {"count": 3, "op": "vmacc", "dims": [49, 96], "dtype": "float32"}]}


def plain_answers(seed):
    answers = []
    for op, args in zip(inputs.expand(SMALL),
                        inputs.for_launches(SMALL, seed, "cpu")):
        if op["op"] == "qmatmul":
            out = qmatmul_plain(*args, 0.01, 32)
        else:
            out = vmacc_plain(*args)
        answers.append(harness.Answer(op["op"], args, out))
    return answers


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_agrees_with_the_plain_versions(seed):
    numbers = check.readings(plain_answers(seed), SMALL)
    assert numbers["qmm_mismatched"] == 0
    assert numbers["vmacc_rel_err"] <= 2.0 ** -23


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_a_limit(seed):
    answers = plain_answers(seed)
    numbers = check.readings(answers, SMALL, against="control")
    over = [name for name, v in numbers.items()
            if v > LIMITS[name]]
    assert set(over) == {"qmm_mismatched", "vmacc_rel_err"}


def test_requantize_rounds_half_to_even_and_clips():
    acc = torch.tensor([[50, 150, 250, 13000, -13000]], dtype=torch.int64)
    out = qmatmul.requantize(acc, torch.zeros(5, dtype=torch.int32), 0.01)
    want = torch.round(acc.to(torch.float32) * torch.tensor(0.01))
    assert out.tolist() == [[int(v) for v in want.clamp(-128, 127)[0]]]
