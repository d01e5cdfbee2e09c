"""On a card: the program's readings at each cell's own sizes stay within
each limit, and the control's (the reference one precision lower in the
program's place) break at least one. Every cell of ``BENCHMARK.json``
whose mix runs the ``passes`` loop is checked. ``python -m pytest -q -m
gpu portbench``; skips without a card."""

import pytest

from portbench import control, harness
from portbench.reference import family

MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if harness.find_cell(MANIFEST, w["name"]).traffic["loop"]
         == "passes"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond_the_limits(card, cell):
    from repro_torch.core.runner import CudaRunner

    found = harness.find_cell(MANIFEST, cell)
    out = control.readings(found, seed=2**31 + 101, seeds=3,
                           control_seeds=3, device="cuda",
                           runner_class=CudaRunner)
    limits = {family(op["op"]).NUMBER: family(op["op"]).LIMIT
              for op in found.config["ops"]}
    for name, values in out["program"].items():
        assert max(values) <= limits[name], (name, values)
    for i in range(3):
        assert any(values[i] > limits[name]
                   for name, values in out["control"].items())
