"""The decode cell's files on the CPU: the benchmark's plain reference of
Qwen1.5-MoE decode against the repo's own copy, its bytes and operations
against the hand figures of the cell's sizing, the ``decode`` loop run end
to end at a tiny size through the port's ``Server`` (sound, it comes out
correct; with a planted fault in the program, ``correct`` comes out
false), and the MoE layer's readers on a traced run and on a trace made up
for the purpose."""

import importlib.util
import os
import time

import pytest
import torch

from portbench import harness, roofline
from portbench.loops import decode
from portbench.metrics import moe_experts_read, moe_roofline
from portbench.reference import qwen_moe_decode as fam
from portbench.trace import Trace
from repro_torch.configs import get_config
from repro_torch.models import layers, moe

MANIFEST = harness.load_manifest()
CELL = "qwen1.5-moe-a2.7b-b4.decode"

TINY_MODEL = dict(fam.PUBLISHED, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4,
                  moe_intermediate_size=32,
                  shared_expert_intermediate_size=128, vocab_size=256,
                  max_position_embeddings=24)
# at width 64 a spread of 1/8 gives projections' outputs the spread that
# 0.02 gives at the published 2048
ASSUMED = {"init_std": 0.125, "qkv_bias_std": 0.5}
MIX = {"loop": "decode", "warmup_steps": 2, "trace_steps": 2,
       "sample_steps": 4, "rotate_bytes": 0}
E2E = ["infer_ms", "infer_p95_ms", "setup_s"]
PER_LAYER = ["pass_mfu", "moe_experts_read", "moe_roofline"]


def tiny(dtype="bfloat16"):
    return {"name": "tiny", "arch": "qwen1_5_moe_a2_7b", "model": TINY_MODEL,
            "assumed": ASSUMED, "ops": [{"count": 1, "op": "qwen_moe_decode",
                                         "dims": [2, 6, 24], "dtype": dtype}]}


def drive(trace=False, seed=2**31 + 5, seconds=0.05):
    torch.set_num_threads(1)
    units = {name: "-" for name in E2E + PER_LAYER}
    cell = harness.Cell(name="tiny.decode", config=tiny(), traffic=MIX,
                        chips=1, units=units, end_to_end=E2E,
                        per_layer=PER_LAYER)
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", t0=time.perf_counter(),
                          runner_class=None)
    return harness.execute(ctx)[0]


def repo_reference():
    path = os.path.join(harness.ROOT, "tests", "_qwen1_5_moe_reference.py")
    spec = importlib.util.spec_from_file_location("_qwen_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- reference --

@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_benchmark_reference_equals_the_repo_s(norm_topk_prob):
    model = dict(TINY_MODEL, norm_topk_prob=norm_topk_prob)
    w, ids = fam.inputs((3, 11, 24), "float32", ASSUMED,
                        torch.Generator().manual_seed(3), "cpu", model=model)
    got = fam.reference((model, w, ids), ASSUMED)
    want = repo_reference().forward(model, w, ids)[:, -1]
    # both float32, summed in other orders (attention in query blocks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert fam.error(got, want, None) < 1e-5


def test_control_moves_the_logits():
    w, ids = fam.inputs((2, 9, 24), "bfloat16", ASSUMED,
                        torch.Generator().manual_seed(4), "cpu",
                        model=TINY_MODEL)
    args = (TINY_MODEL, w, ids)
    want = fam.reference(args, ASSUMED)
    assert fam.error(fam.control(args, ASSUMED), want, args) > 1e-2
    assert fam.error(want[:1], want, args) == float("inf")


# ------------------------------------------------ bytes and operations --

def test_step_bytes_and_operations_are_the_sizing_s():
    """The figures of the cell's sizing: attention weights 0.81 GB, about
    14.47 distinct routed experts a layer (6.01 GB), the shared expert
    1.66 GB, the head 0.62 GB, the cache at mid-window (6144 positions)
    4.83 GB: 13.94 GB, 4.16 ms at 3.35 TB/s; the projections 19.0 GFLOP
    and attention at mid-window 4.83 GFLOP."""
    dims, gb = (4, 4096, 8192), 1e9
    assert fam.distinct_experts(4) == pytest.approx(14.47, abs=5e-3)
    assert 24 * fam.distinct_experts(4) * fam.expert_bytes("bfloat16") \
        / gb == pytest.approx(6.01, abs=5e-3)
    router_and_gate = 24 * (2048 * 60 + 2048) * 2
    assert (24 * fam.moe_weight_bytes("bfloat16") - router_and_gate) / gb \
        == pytest.approx(1.66, abs=5e-3)
    total = fam.op_bytes(dims, "bfloat16")
    assert total / gb == pytest.approx(0.81 + 6.01 + 1.66 + 0.62 + 4.83,
                                       abs=0.01)
    assert 12.3 <= total / gb <= 15.5
    assert roofline.bound_s("qwen_moe_decode", dims, "bfloat16") * 1e3 \
        == pytest.approx(4.16, abs=5e-3)
    attention = 4 * 24 * 4 * 2048 * 6144
    assert fam.op_ops(dims) == pytest.approx(19.0e9 + attention, rel=2e-3)
    assert attention / gb == pytest.approx(4.83, abs=5e-3)


def test_cell_files_hold_the_published_model():
    cell = harness.find_cell(MANIFEST, CELL)
    assert cell.config["model"] == fam.PUBLISHED
    assert cell.config["reduced"] == []
    assert decode.port_config(cell.config) == get_config(cell.config["arch"])
    assert set(cell.per_layer) >= {"moe_roofline", "moe_experts_read",
                                   "idle_share", "pass_mfu"}


# ------------------------------------------------------------ the loop --

def test_sound_run_is_correct():
    line = drive()
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == set(E2E)
    assert line["checks"]["decode_logit_rel_err"]["value"] \
        < fam.LIMIT / 4
    assert line["checks"]["missing_answers"]["value"] == 0
    assert line["attempted"] >= MIX["sample_steps"]


def test_rows_restart_after_their_prompts():
    """A window longer than the cache: the rows pass max_len and restart,
    and the last step's answer still holds."""
    line = drive(seconds=1.0)
    assert line["attempted"] > 24
    assert line["correct"]


def test_traced_run_reads_the_moe_counters():
    line = drive(trace=True)
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    # no card: no device operations, so no roofline is read
    assert set(got) == {"pass_mfu", "moe_experts_read"}
    assert 1 <= got["moe_experts_read"] <= TINY_MODEL["num_experts"]


def renormalised(real):
    def top_k(logits, cfg):
        sel, gates = real(logits, cfg)
        return sel, gates / gates.sum(-1, keepdim=True)
    return top_k


def switched(**changes):
    real = decode.port_config

    def port_config(config):
        import dataclasses
        return dataclasses.replace(real(config), **changes)
    return port_config


def cache_never_written(real):
    def attention_decode(x, p, cfg, k_cache, v_cache, *args):
        return real(x, p, cfg, k_cache.clone(), v_cache.clone(), *args)
    return attention_decode


FAULTS = {
    "top-k renormalised": (moe, "top_k", renormalised),
    "shared expert ungated": (decode, "port_config",
                              lambda _: switched(shared_expert_gate=False)),
    "q/k/v biases left out": (decode, "port_config",
                              lambda _: switched(qkv_bias=False)),
    "cache write skipped": (layers, "_attention_decode",
                            cache_never_written),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    module, name, make = FAULTS[fault]
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    line = drive(seconds=0.2)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["decode_logit_rel_err"]["value"] > fam.LIMIT


# -------------------------------------------------------------- readers --

def test_kernels_are_counted_by_the_span_that_launched_them():
    spans = [(100, 200), (300, 400)]
    host = [(1, 150), (2, 250), (3, 300), (4, 410)]
    device = [(1, 210, 260, "a"), (2, 260, 280, "b"), (3, 420, 500, "c"),
              (4, 500, 510, "d"), (9, 120, 130, "e")]
    assert decode.launched_in(host, device, spans) == [
        (210, 260, "a"), (420, 500, "c")]


def test_moe_readers_on_a_made_up_trace():
    cell = harness.find_cell(MANIFEST, CELL)
    kernels = [(0, 600_000, "mm"), (600_000, 1_000_000, "index")]  # 1 ms
    facts = {"passes_traced": 2, "moe_calls": 48, "experts_read": 700,
             "moe_kernels": kernels}
    run = harness.Run(attempted=0, end_to_end={}, answers=[],
                      expected_answers=0, memory_peak_bytes=0,
                      trace=Trace((0, 10**7), [], []), facts=facts)
    moved = 700 * fam.expert_bytes("bfloat16") \
        + 48 * fam.moe_fixed_bytes(4, "bfloat16")
    assert moe_roofline.read(run, cell) == pytest.approx(
        100 * moved / 3.35e12 / 1e-3)
    assert moe_experts_read.read(run, cell) == pytest.approx(700 / 48)
    # a parent without the spans reads nothing
    bare = harness.Run(attempted=0, end_to_end={}, answers=[],
                       expected_answers=0, memory_peak_bytes=0, trace=None)
    assert moe_roofline.read(bare, cell) is None
    assert moe_experts_read.read(bare, cell) is None
