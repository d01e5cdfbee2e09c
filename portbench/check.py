"""The comparison that decides ``correct``.

Each answer the timed path produced is set beside the plain reference of
its op family (``reference/<op>.py``), computed on the same inputs once the
window has closed. Each family compares by one number with its own limit
(``qmm_mismatched``: int8 outputs unlike the reference's, limit 0;
``vmacc_rel_err``: the largest error relative to ``|a*b| + |c|``, limit
1e-4); ``missing_answers`` counts the answers that were due and never came
(an op left out of a pass), limit 0.
"""

from __future__ import annotations

import dataclasses

from portbench.reference import family

MISSING = "missing_answers"


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int
    numbers: dict[str, tuple[float, float]]   # name -> (reading, limit)


def reading(answer, assumed: dict, against: str = "reference") -> float:
    """This answer's reading against its family's reference (or, with
    ``against="control"``, the control put in the program's place)."""
    fam = family(answer.op)
    want = fam.reference(answer.inputs, assumed)
    got = answer.output if against == "reference" \
        else fam.control(answer.inputs, assumed)
    return fam.error(got, want, answer.inputs)


def combine(numbers: dict, fam, value: float) -> None:
    old = numbers.get(fam.NUMBER, 0.0)
    numbers[fam.NUMBER] = old + value if fam.COMBINE == "sum" \
        else max(old, value)


def readings(answers, config: dict, against: str = "reference") -> dict:
    """Each number over all ``answers``."""
    numbers: dict[str, float] = {}
    for answer in answers:
        combine(numbers, family(answer.op),
                reading(answer, config["assumed"], against))
    return numbers


def judge(run, config: dict) -> Verdict:
    """Compare every answer of ``run`` with the reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    values: dict[str, float] = {}
    limits: dict[str, float] = {}
    failed = 0
    for answer in run.answers:
        fam = family(answer.op)
        value = reading(answer, config["assumed"])
        failed += not value <= fam.LIMIT
        combine(values, fam, value)
        limits[fam.NUMBER] = fam.LIMIT
    missing = max(0, run.expected_answers - len(run.answers))
    failed += missing
    numbers = {name: (values[name], limits[name]) for name in values}
    numbers[MISSING] = (float(missing), 0)
    correct = all(v <= lim for v, lim in numbers.values())
    return Verdict(correct=correct, failed=failed, numbers=numbers)
