"""A run driven end to end on the CPU, past the look for a card, at a size
a test run holds: sound, it comes out correct; with the timed path broken
underneath (an answer altered where it is produced, half of an answer left
out, a launch that returns its input unchanged or an answer of other
operands), ``correct`` comes out false."""

import time

import pytest
import torch

from portbench import harness, inputs
from repro_torch import kernels
from repro_torch.core.runner import EmulateRunner

ASSUMED = {"requant_scale": 0.01, "qmatmul_out_std": 30,
           "qmatmul_bias_range": 1000, "vmacc_std": 0.5}
TINY = {"name": "tiny", "assumed": ASSUMED, "ops": [
    {"count": 1, "op": "qmatmul", "dims": [64, 32, 27], "dtype": "int8"},
    {"count": 3, "op": "vmacc", "dims": [32, 64], "dtype": "float32"},
    {"count": 2, "op": "qmatmul", "dims": [16, 64, 96], "dtype": "int8"}]}
MIX = {"loop": "passes", "trials_per_workload": 4, "pipeline_depth": 2,
       "warmup_passes": 1, "trace_passes": 2, "sample_passes": 3,
       "tune_seed": 7}
E2E = ["infer_ms", "infer_p95_ms", "setup_s"]
PER_LAYER = ["tuned_sum_us", "tuned_share", "pass_mfu"]


def drive(trace=False, seed=2**31 + 3, sets=1):
    """A run of the tiny cell whose passes cycle through ``sets`` sets of
    operands."""
    torch.set_num_threads(1)
    units = {name: "-" for name in E2E + PER_LAYER}
    traffic = dict(MIX, rotate_bytes=inputs.pass_bytes(TINY) * (sets - 0.5))
    cell = harness.Cell(name="tiny.infer", config=TINY, traffic=traffic,
                        chips=1, units=units, end_to_end=E2E,
                        per_layer=PER_LAYER)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.05, trace=trace,
                          device="cpu", t0=time.perf_counter(),
                          runner_class=EmulateRunner)
    return harness.execute(ctx)[0]


def altered(op, change):
    """``kernels.build`` whose ``op`` kernels hand back ``change(out,
    args)``."""
    build = kernels.build

    def broken(workload, params, device="cuda", cache=None):
        fn = build(workload, params, device=device, cache=cache)
        if workload.op != op:
            return fn

        def wrapped(*args):
            return change(fn(*args), args)
        return wrapped
    return broken


def bump_one(out, args):
    out = out.clone()
    out.view(-1)[out.numel() // 2] += 1
    return out


def shift_one(out, args):
    out = out.clone()
    out.view(-1)[0] += 1e-2 * (out.view(-1)[0].abs() + 1.0)
    return out


def rows_left_out(out, args):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def half_left_out(out, args):
    out = out.clone()
    flat = out.view(-1)
    flat[flat.numel() // 2:] = 0
    return out


def stale():
    """A kernel that hands back its first answer for every later call."""
    first = []

    def change(out, args):
        if not first:
            first.append(out)
        return first[0]
    return change


FAULTS = {
    "qmatmul answer altered": ("qmatmul", lambda: bump_one),
    "qmatmul rows left out": ("qmatmul", lambda: rows_left_out),
    "qmatmul answer stale across operand sets": ("qmatmul", stale),
    "vmacc answer altered": ("vmacc", lambda: shift_one),
    "vmacc half left out": ("vmacc", lambda: half_left_out),
    "vmacc returns c unchanged": ("vmacc", lambda: lambda out, args: args[2]),
}


@pytest.mark.parametrize("sets", [1, 3])
def test_sound_run_is_correct(sets):
    line = drive(sets=sets)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == set(E2E)
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("sets", [1, 3])
def test_traced_run_reads_per_layer_metrics(sets):
    line = drive(trace=True, sets=sets)
    assert line["correct"]
    assert set(line["metrics"]) == set(PER_LAYER)
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    op, change = FAULTS[fault]
    monkeypatch.setattr(kernels, "build", altered(op, change()))
    line = drive(sets=3)
    assert line["correct"] is False
    assert line["failed"] > 0
