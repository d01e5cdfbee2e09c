"""On a card: the decode cell's readings at its own sizes, the program's
within ``decode_logit_rel_err``'s limit and the float8 control's beyond it,
with nothing dropped and at most 16 experts read a layer at batch 4
(``control_decode.py``). ``python -m pytest -q -m gpu portbench``; skips
without a card."""

import pytest

from portbench import control_decode, harness
from portbench.reference import qwen_moe_decode as fam

CELL = "qwen1.5-moe-a2.7b-b4.decode"


@pytest.mark.gpu
def test_program_within_and_control_beyond_the_limit(card):
    cell = harness.find_cell(harness.load_manifest(), CELL)
    out = control_decode.readings(cell, seed=2**31 + 103, seeds=2,
                                  control_seeds=1, steps=3, device="cuda")
    assert max(out["program"][fam.NUMBER]) <= fam.LIMIT, out
    assert min(out["control"][fam.NUMBER]) > fam.LIMIT, out
    counts = out["counters"]
    assert counts["moe.dropped"] == 0
    layers = cell.config["model"]["num_hidden_layers"]
    calls = 2 * layers * 3        # decode steps; the prefill's calls below
    assert counts["moe.experts_read"] <= 16 * calls + 2 * layers * 60
