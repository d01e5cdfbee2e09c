"""``qmm_wgmma_share`` on traces made by hand: the share of ``qmm_kernel``
card time in the wgmma loop's kernels, as the profiler names them."""

import types

import pytest

from portbench.metrics import qmm_wgmma_share
from portbench.trace import Trace

MMA = "void (anonymous namespace)::qmm_kernel<2, 1>((anonymous namespace)::Args)"
WG = ("void (anonymous namespace)::wgmma::qmm_kernel<64>((anonymous "
      "namespace)::wgmma::Args)")
VMACC = "void (anonymous namespace)::vmacc_kernel<float, 4>(Args)"


def run_of(device, passes=2):
    trace = Trace((0, 10**6), device, [])
    return types.SimpleNamespace(trace=trace,
                                 facts={"passes_traced": passes})


@pytest.mark.parametrize("device,share", [
    ([(0, 300, WG), (400, 500, MMA)], 75.0),
    ([(0, 300, WG), (300, 400, VMACC)], 100.0),
    ([(0, 100, MMA), (100, 900, VMACC)], 0.0),
], ids=["both", "wgmma-only", "mma-only"])
def test_share_of_qmm_time(device, share):
    assert qmm_wgmma_share.read(run_of(device), None) == pytest.approx(share)


def test_none_without_qmm_kernels_or_trace():
    assert qmm_wgmma_share.read(run_of([(0, 100, VMACC)]), None) is None
    assert qmm_wgmma_share.read(run_of([(0, 100, WG)], passes=0), None) \
        is None
    assert qmm_wgmma_share.read(types.SimpleNamespace(
        trace=None, facts={"passes_traced": 2}), None) is None
