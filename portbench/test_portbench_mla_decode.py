"""The latent-attention decode cell's files on the CPU: the benchmark's plain
reference of Moonlight-16B-A3B decode against the repo's own copy, and its
taking of the program's experts at the checked position; its bytes and
operations against the hand figures of the cell's sizing; the
``mla_decode`` loop run end to end at a tiny size through the port's
``Server`` (sound, it comes out correct; with a planted fault in the
program, ``correct`` comes out false); and ``mla_roofline`` and the MoE
layer's readers on a traced run and on a trace made up for the purpose."""

import dataclasses
import importlib.util
import os
import time
import types

import pytest
import torch

from portbench import harness, roofline
from portbench.loops import mla_decode
from portbench.metrics import mla_roofline, moe_experts_read, moe_roofline
from portbench.reference import moonlight_decode as fam
from portbench.trace import Trace
from repro_torch.configs import get_config
from repro_torch.models import mla, moe

MANIFEST = harness.load_manifest()
CELL = "moonlight-16b-a3b-b16.mla_decode"

TINY_MODEL = dict(fam.PUBLISHED, hidden_size=64, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=4,
                  kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,
                  moe_intermediate_size=32, intermediate_size=128,
                  vocab_size=256, max_position_embeddings=24)
# at width 64 a spread of 1/8 gives projections' outputs the spread that
# 0.02 gives at the published 2048; a bias of 0.2 moves enough of 8
# experts' choices that a rule without it disagrees beyond MAX_DISAGREE
ASSUMED = {"init_std": 0.125, "bias_std": 0.2}
MIX = {"loop": "mla_decode", "warmup_steps": 2, "trace_steps": 2,
       "sample_steps": 4, "rotate_bytes": 0}
E2E = ["infer_ms", "infer_p95_ms", "setup_s"]
PER_LAYER = ["pass_mfu", "moe_experts_read", "moe_roofline", "mla_roofline"]


def tiny(dtype="bfloat16"):
    return {"name": "tiny", "arch": "moonlight_16b_a3b", "model": TINY_MODEL,
            "assumed": ASSUMED, "ops": [{"count": 1, "op": "moonlight_decode",
                                         "dims": [2, 6, 24], "dtype": dtype}]}


def drive(trace=False, seed=2**31 + 7, seconds=0.05):
    torch.set_num_threads(1)
    units = {name: "-" for name in E2E + PER_LAYER}
    cell = harness.Cell(name="tiny.mla_decode", config=tiny(), traffic=MIX,
                        chips=1, units=units, end_to_end=E2E,
                        per_layer=PER_LAYER)
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", t0=time.perf_counter(),
                          runner_class=None)
    return harness.execute(ctx)[0]


def repo_reference():
    path = os.path.join(harness.ROOT, "tests",
                        "_moonlight_16b_a3b_reference.py")
    spec = importlib.util.spec_from_file_location("_moonlight_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_inputs(dims, dtype="float32", seed=3):
    return fam.inputs(dims, dtype, ASSUMED, torch.Generator().manual_seed(
        seed), "cpu", model=TINY_MODEL)


# ------------------------------------------------------------- reference --

def test_benchmark_reference_equals_the_repo_s():
    w, ids = tiny_inputs((3, 11, 24))
    got = fam.logits_at_last(TINY_MODEL, w, ids)
    want = repo_reference().forward(TINY_MODEL, w, ids)[:, -1]
    # both float32, summed in other orders (attention in query blocks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert fam.error(got, want, None) < 1e-5


def own_choices(w, ids):
    """The reference's own experts at the last position of every row, each
    MoE layer's, from its own routing."""
    found = []
    real = torch.topk

    def spy(x, k, dim=-1):
        out = real(x, k, dim=dim)
        found.append(out.indices.view(ids.shape[0], ids.shape[1], k)[:, -1])
        return out
    fam.torch.topk = spy
    try:
        fam.logits_at_last(TINY_MODEL, w, ids)
    finally:
        fam.torch.topk = real
    return torch.stack(found).int()


def test_reference_takes_the_program_s_experts_and_holds_them_to_its_own():
    w, ids = tiny_inputs((3, 11, 24))
    own = own_choices(w, ids)
    want = fam.logits_at_last(TINY_MODEL, w, ids)
    found = []
    same = fam.logits_at_last(TINY_MODEL, w, ids, experts=own, found=found)
    torch.testing.assert_close(same, want, rtol=1e-6, atol=1e-6)
    assert fam.disagree(found, own) == 0.0
    # the order of a row's experts is no decision
    flipped = fam.reference((TINY_MODEL, w, ids, own.flip(-1)), {})
    torch.testing.assert_close(flipped, want, rtol=1e-5, atol=1e-5)
    # one choice of 18 elsewhere is taken: that row's logits move, no other
    other = own.clone()
    other[1, 1, 0] = next(e for e in range(8)
                          if e not in own[1, 1].tolist())
    found = []
    moved = fam.logits_at_last(TINY_MODEL, w, ids, experts=other,
                               found=found)
    assert fam.disagree(found, other) == pytest.approx(1 / 18)
    assert not torch.isnan(fam.reference((TINY_MODEL, w, ids, other),
                                         {})).any()
    assert (moved[1] - want[1]).abs().max() > 1e-3
    torch.testing.assert_close(moved[[0, 2]], want[[0, 2]], rtol=1e-6,
                               atol=1e-6)
    # beyond MAX_DISAGREE, or an expert named twice, the reference is NaN
    # and the comparison reads infinite
    rotated = (own + 1) % 8
    got = fam.reference((TINY_MODEL, w, ids, rotated), {})
    assert torch.isnan(got).all()
    assert fam.error(want, got, None) == float("inf")
    twice = own.clone()
    twice[0, 2, 1] = twice[0, 2, 0]
    assert torch.isnan(fam.reference((TINY_MODEL, w, ids, twice),
                                     {})).all()


def test_control_moves_the_logits():
    w, ids = tiny_inputs((2, 9, 24), dtype="bfloat16", seed=4)
    experts = own_choices(w, ids)
    args = (TINY_MODEL, w, ids, experts)
    want = fam.reference(args, ASSUMED)
    assert fam.error(fam.control(args, ASSUMED), want, args) > 1e-2
    assert fam.error(want[:1], want, args) == float("inf")


# ------------------------------------------------ bytes and operations --

def test_step_bytes_and_operations_are_the_sizing_s():
    """The figures of the cell's sizing: 26 MoE layers of ~50.75 distinct
    routed experts of 17.30 MB (22.83 GB), the latent cache at mid-window
    (6144 positions) 3.06 GB, the shared experts with router and bias 0.91
    GB, the attention weights 0.74 GB, the head 0.67 GB, the dense MLP 0.14
    GB: 28.35 GB, 8.46 ms at 3.35 TB/s."""
    dims, gb = (16, 4096, 8192), 1e9
    assert fam.distinct_experts(16) == pytest.approx(50.75, abs=5e-3)
    assert fam.expert_bytes("bfloat16") / 1e6 == pytest.approx(17.30,
                                                               abs=5e-3)
    experts = 26 * fam.distinct_experts(16) * fam.expert_bytes("bfloat16")
    assert experts / gb == pytest.approx(22.83, abs=5e-3)
    assert 26 * fam.moe_weight_bytes("bfloat16") / gb == pytest.approx(
        0.91, abs=5e-3)
    assert 27 * fam.attn_weight_bytes("bfloat16") / gb == pytest.approx(
        0.74, abs=5e-3)
    cache = 27 * 16 * 6145 * 576 * 2
    assert cache / gb == pytest.approx(3.06, abs=5e-3)
    total = fam.op_bytes(dims, "bfloat16")
    assert total / gb == pytest.approx(
        22.83 + 3.06 + 0.91 + 0.74 + 0.67 + 0.14, abs=0.02)
    assert roofline.bound_s("moonlight_decode", dims, "bfloat16") * 1e3 \
        == pytest.approx(8.46, abs=0.01)
    # operations: a row's absorbed attention projections, its experts, the
    # dense layer and the head, then the scores (576) and output (512) of
    # 16 heads over 6144 positions in each of 27 layers
    attn = 2048 * 3072 + 2048 * 576 + 2 * 16 * 128 * 512 + 2048 * 2048
    moe_row = 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 2048 * 64
    per_row = 27 * (attn + 16 * 1088 * 6144) + 26 * moe_row \
        + 3 * 2048 * 11264 + 2048 * 163840
    assert fam.op_ops(dims) == pytest.approx(2 * 16 * per_row, rel=1e-9)


def test_cell_files_hold_the_published_model():
    cell = harness.find_cell(MANIFEST, CELL)
    assert cell.config["model"] == fam.PUBLISHED
    # the published keys stand at the file's top level as well, where a
    # check against the config.json reads them; ``model`` is what the
    # loop, the reference and the MoE readers read
    assert {k: cell.config.get(k, "missing") for k in fam.PUBLISHED} \
        == fam.PUBLISHED
    assert cell.config["reduced"] == []
    assert cell.config["ops"][0]["dims"] == [16, 4096, 8192]
    assert mla_decode.port_config(cell.config) == get_config(
        cell.config["arch"])
    assert set(cell.per_layer) == {"moe_roofline", "moe_experts_read",
                                   "idle_share", "pass_mfu", "mla_roofline"}
    assert set(cell.end_to_end) == {"infer_ms", "infer_p95_ms", "setup_s"}


# ------------------------------------------------------------ the loop --

def test_sound_run_is_correct():
    line = drive()
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == set(E2E)
    assert line["checks"]["decode_logit_rel_err"]["value"] < fam.LIMIT / 2
    assert line["checks"]["missing_answers"]["value"] == 0
    assert line["attempted"] >= MIX["sample_steps"]


def test_rows_restart_after_their_prompts():
    line = drive(seconds=1.0)
    assert line["attempted"] > 24
    assert line["correct"]


def test_traced_run_reads_the_moe_counters():
    line = drive(trace=True)
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    # no card: no device operations, so no roofline is read
    assert set(got) == {"pass_mfu", "moe_experts_read"}
    assert 1 <= got["moe_experts_read"] <= TINY_MODEL["n_routed_experts"]


def switched(**changes):
    real = mla_decode.port_config

    def port_config(config):
        return dataclasses.replace(real(config), **changes)
    return port_config


def row_never_written(real):
    def write_row(cache, row, pos):
        return None
    return write_row


FAULTS = {
    "correction bias ignored": (mla_decode, "port_config",
                                lambda _: switched(topk_method="greedy")),
    "softmax scoring": (mla_decode, "port_config",
                        lambda _: switched(scoring_func="softmax")),
    "no routed scaling": (mla_decode, "port_config",
                          lambda _: switched(routed_scaling_factor=1.0)),
    "latent row never written": (mla, "write_row", row_never_written),
    "no kv_a RMSNorm": (mla, "kv_norm", lambda _: lambda c, s: c),
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

KERNEL = ("(anonymous namespace)::mla_decode_kernel((anonymous namespace)"
          "::Params)")
COMBINE = ("(anonymous namespace)::mla_decode_combine(float const*, "
           "__nv_bfloat16*, int)")
OTHER = "(anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 128, 1>"


def run_of(device, steps=10):
    return types.SimpleNamespace(trace=Trace((0, 10**12), device, []),
                                 facts={"passes_traced": steps})


def test_mla_bytes_at_the_traced_positions_by_hand():
    cell = harness.find_cell(MANIFEST, CELL)
    # a step at 4104: 27 layers x 16 rows x 4105 positions x 576 x 2 bytes,
    # and each head's q in (576) and output out (512): 27 x 16 x 16 x 1088
    # x 2 bytes
    want = 27 * 16 * 4105 * 576 * 2 + 27 * 16 * 16 * 1088 * 2
    assert mla_roofline.step_bytes(cell.config["model"], 16, 4104,
                                   "bfloat16") == want
    moved = sum(mla_roofline.step_bytes(cell.config["model"], 16, pos,
                                        "bfloat16")
                for pos in range(4104, 4114))
    ns = round(moved / roofline.HBM_BYTES_PER_S * 1e9)
    run = run_of([(0, ns - 1000, KERNEL), (ns - 1000, ns, COMBINE),
                  (ns, ns + 5000, OTHER)])
    share = mla_roofline.read(run, cell)
    assert share == pytest.approx(100.0, rel=1e-6) and share <= 100.0 + 1e-6
    assert mla_roofline.read(run_of([(0, 2 * ns, KERNEL)]), cell) \
        == pytest.approx(50.0, rel=1e-6)
    # none without the kernel, steps or a trace: the parent's runs
    assert mla_roofline.read(run_of([(0, 100, OTHER)]), cell) is None
    assert mla_roofline.read(run_of([(0, 100, KERNEL)], steps=0),
                             cell) is None
    assert mla_roofline.read(types.SimpleNamespace(
        trace=None, facts={"passes_traced": 10}), cell) is None


def test_moe_readers_count_the_two_shared_experts():
    cell = harness.find_cell(MANIFEST, CELL)
    kernels = [(0, 1_000_000, "moe_up_kernel")]  # 1 ms
    facts = {"passes_traced": 2, "moe_calls": 52, "experts_read": 2600,
             "moe_kernels": kernels}
    run = harness.Run(attempted=0, end_to_end={}, answers=[],
                      expected_answers=0, memory_peak_bytes=0,
                      trace=Trace((0, 10**7), [], []), facts=facts)
    fixed = (3 * 2048 * 2816 + 2048 * 64 + 64 + 2 * 16 * 2048) * 2
    assert fam.moe_fixed_bytes(16, "bfloat16") == fixed
    moved = 2600 * 3 * 2048 * 1408 * 2 + 52 * fixed
    assert moe_roofline.read(run, cell) == pytest.approx(
        100 * moved / 3.35e12 / 1e-3)
    assert moe_experts_read.read(run, cell) == pytest.approx(50.0)


def test_the_step_records_the_experts_the_reference_is_handed():
    """The decode state's ``experts`` after a step are the routing of that
    step's hidden states, as the MoE layer chose them."""
    cfg = mla_decode.port_config(tiny())
    assert cfg.moe_dropless and cfg.topk_method == "noaux_tc"
    cache = moe.init_cache(cfg, 2, 8, device="cpu")
    assert tuple(cache["experts"].shape) == (2, 2, 3)
