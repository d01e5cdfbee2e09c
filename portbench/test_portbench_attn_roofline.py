"""``attn_roofline`` on traces made by hand: the bytes the decode cell's
traced steps' attention must move at their positions, counted by hand, over
the card time of the decode-attention kernels as the profiler names them."""

import types

import pytest

from portbench import harness, roofline
from portbench.metrics import attn_roofline
from portbench.trace import Trace

CELL = harness.find_cell(harness.load_manifest(),
                         "qwen1.5-moe-a2.7b-b4.decode")
KERNEL = ("void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16"
          ", 128, 1>((anonymous namespace)::Params)")
COMBINE = ("void (anonymous namespace)::decode_attention_combine<__nv_"
           "bfloat16>(float const*, __nv_bfloat16*, int, int, int)")
GEMV = "internal::gemvx::kernel<int, int, float, float, float, float>"


def run_of(device, steps=10):
    return types.SimpleNamespace(trace=Trace((0, 10**12), device, []),
                                 facts={"passes_traced": steps})


def test_bytes_at_the_traced_positions_by_hand():
    # 4096-token prompts, 8 warm-up steps: the 10 traced steps feed 4104-4113
    assert attn_roofline.traced_positions(CELL.config, CELL.traffic, 10) \
        == list(range(4104, 4114))
    # a step at 4104: 24 layers x 4 rows x 16 KV heads x 4105 positions x
    # 128 x (K and V) x 2 bytes, and q in and the output out: 24 x 4 x 16
    # heads x 128 x 2 x 2 bytes
    want = 24 * 4 * 16 * 4105 * 128 * 2 * 2 + 24 * 4 * 16 * 128 * 2 * 2
    assert attn_roofline.step_bytes(CELL.config["model"], 4, 4104,
                                    "bfloat16") == want


def test_positions_restart_after_the_prompt():
    traffic = dict(CELL.traffic, warmup_steps=4094)
    assert attn_roofline.traced_positions(CELL.config, traffic, 4) \
        == [8190, 8191, 4096, 4097]


def test_share_is_100_when_the_card_time_is_the_bound():
    moved = sum(attn_roofline.step_bytes(CELL.config["model"], 4, pos,
                                         "bfloat16")
                for pos in range(4104, 4114))
    ns = round(moved / roofline.HBM_BYTES_PER_S * 1e9)
    run = run_of([(0, ns - 1000, KERNEL), (ns - 1000, ns, COMBINE),
                  (ns, ns + 5000, GEMV)])
    share = attn_roofline.read(run, CELL)
    assert share == pytest.approx(100.0, rel=1e-6) and share <= 100.0 + 1e-6
    half = run_of([(0, 2 * ns, KERNEL)])
    assert attn_roofline.read(half, CELL) == pytest.approx(50.0, rel=1e-6)


def test_none_without_the_kernel_or_a_trace():
    assert attn_roofline.read(run_of([(0, 100, GEMV)]), CELL) is None
    assert attn_roofline.read(run_of([(0, 100, KERNEL)], steps=0), CELL) \
        is None
    assert attn_roofline.read(types.SimpleNamespace(
        trace=None, facts={"passes_traced": 10}), CELL) is None
