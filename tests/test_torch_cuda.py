"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same device tensors, launch refusal on both sides of
each launch gate, the CUDA runner, interleaved sessions and dispatch. They
need a CUDA device and skip without one.

Run on a machine with an H100:  python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (H100, CudaRunner, Schedule, TuningDatabase,  # noqa: E402
                              TuningSession, concretize, kernel_params,
                              space_for, tune)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.tuner import effective_pipeline_depth  # noqa: E402
from repro_torch.core.space import KernelParams  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._build import KernelLaunchError  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_blocked, plain_version as fa_plain_version)
from repro_torch.kernels.gemv import ops as gemv_ops  # noqa: E402
from repro_torch.kernels.gemv import plain as gemv_plain  # noqa: E402
from repro_torch.kernels.gemv.kernel import gemv_blocked  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.kernels.matmul import plain as matmul_plain  # noqa: E402
from repro_torch.kernels.matmul.kernel import matmul_blocked  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qmatmul_ops  # noqa: E402
from repro_torch.kernels.qmatmul import plain as qmatmul_plain  # noqa: E402
from repro_torch.kernels.qmatmul.kernel import (  # noqa: E402
    qmatmul_blocked, qmatmul_ragged)
from repro_torch.kernels.vmacc import ops as vmacc_ops  # noqa: E402
from repro_torch.kernels.vmacc import plain as vmacc_plain  # noqa: E402
from repro_torch.kernels.vmacc.kernel import (  # noqa: E402
    vmacc_blocked, vmacc_ragged)

pytestmark = pytest.mark.gpu

# f32: the kernel sums each k step in another order than the plain block
# product; bf16 inputs are exact in f32, so the same holds there.
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-4, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


def _operands(m, n, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
        return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.parametrize("shape,block", [
    ((64, 1536, 576), (16, 64, 64)),     # W3, the library schedule
    ((64, 1536, 576), (64, 64, 96)),
    ((128, 96, 144), (128, 32, 48)),
    ((48, 32, 16), (16, 16, 16)),
    ((64, 32000, 576), (64, 64, 64)),    # the LM head
    ((64, 1536, 576), (16, 48, 16)),     # off the ladder: bn 48, bk 16
    ((96, 144, 64), (32, 48, 32)),
    ((80, 112, 32), (80, 112, 16)),      # bf16: two 16x16 tiles per warp
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("accumulate,order", [(True, "mnk"), (True, "nmk"),
                                              (False, "mnk")])
def test_matmul_kernels_match_plain(cuda, shape, block, dtype, accumulate,
                                    order):
    m, n, k = shape
    x, w = _operands(m, n, k, dtype, cuda)
    got = matmul_blocked(x, w, block, order, accumulate)
    torch.cuda.synchronize()
    want = matmul_plain.matmul_plain(x, w, block[2])
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape,block", [
    ((3136, 64, 576), (16, 64, 64)),     # W1
    ((64, 32000, 576), (64, 128, 64)),   # W2
    ((32, 96, 64), (32, 32, 32)),
])
def test_qmatmul_kernel_bit_exact(cuda, shape, block):
    m, n, k = shape
    x, w = _operands(m, n, k, torch.int8, cuda, seed=1)
    bias = torch.from_numpy(np.random.default_rng(2).integers(
        -1000, 1000, n).astype(np.int32)).to(cuda)
    got = qmatmul_blocked(x, w, bias, 0.01, block)
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_plain.qmatmul_plain(x, w, bias, 0.01,
                                                        block[2]))


def test_refused_launch_raises_refused(cuda):
    x, w = _operands(256, 256, 32, torch.float32, cuda)
    with pytest.raises(KernelLaunchError) as err:   # 65536 outputs a block
        matmul_blocked(x, w, (256, 256, 32))
    assert err.value.refused
    x, w = _operands(16, 16, 4096, torch.float32, cuda)
    with pytest.raises(KernelLaunchError) as err:   # shared memory > 227 KB
        matmul_blocked(x, w, (16, 16, 4096))
    assert err.value.refused
    torch.cuda.synchronize()  # the context survived both


_GATE_DTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8"}


def _gate_boundary(limit, dtype):
    """Blocks just inside and one step beyond one limit of the Python gate
    (``matmul.ops.supports_block_shape`` at the H100's shared memory)."""
    tensor_cores = dtype != torch.int8
    if limit == "micro_tile":                    # int8: 4x4 per thread
        return (4, 4, 16), (6, 4, 16)
    if limit.startswith("grain_"):               # f32, bf16: 16x16 fragments
        dim = "mnk".index(limit[-1])
        beyond = [16, 16, 16]
        beyond[dim] = 24
        return (16, 16, 16), tuple(beyond)
    if limit == "threads":                       # bm * bn <= 16384
        return (128, 128, 16), ((144, 128, 16) if tensor_cores
                                else (132, 128, 16))
    if limit == "dp4a":                          # int8 bk % 4
        return (4, 4, 4), (4, 4, 6)
    grain = 16 if tensor_cores else 4            # smem
    bk = grain
    while matmul_ops.supports_block_shape(16, 16, bk + grain,
                                          _GATE_DTYPE[dtype],
                                          H100.vmem_capacity):
        bk += grain
    return (16, 16, bk), (16, 16, bk + grain)


@pytest.mark.parametrize("limit,dtype", [
    (limit, torch.int8) for limit in ("micro_tile", "threads", "smem",
                                      "dp4a")
] + [
    (limit, dtype) for dtype in (torch.float32, torch.bfloat16)
    for limit in ("grain_m", "grain_n", "grain_k", "threads", "smem")])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_python_gate_matches_kernel_limits(cuda, limit, dtype, inside):
    """The Python gate and the kernels' own checks (csrc/tile.cuh for int8,
    csrc/matmul.cu's tensor-core launchers for f32 and bf16) agree on both
    sides of every limit: a block the gate accepts launches and is right,
    and one step beyond it the card refuses the launch. (qmatmul has its
    own gate since its kernel moved to the tensor cores:
    test_qmatmul_gate_matches_kernel_limits.)"""
    block = _gate_boundary(limit, dtype)[0 if inside else 1]
    assert matmul_ops.supports_block_shape(
        *block, _GATE_DTYPE[dtype], H100.vmem_capacity) is inside
    x, w = _operands(*block, dtype, cuda)      # one block: (bm, bk) @ (bk, bn)
    pairs = [(lambda acc=acc: matmul_blocked(x, w, block, accumulate=acc),
              lambda: matmul_plain.matmul_plain(x, w, block[2]))
             for acc in (True, False)]
    for call, want in pairs:
        if not inside:
            with pytest.raises(KernelLaunchError) as err:
                call()
            assert err.value.refused
            continue
        got = call()
        torch.cuda.synchronize()
        if dtype == torch.int8:
            assert torch.equal(got, want())
        else:
            rtol, atol = TOL[dtype]
            torch.testing.assert_close(got, want(), rtol=rtol, atol=atol)
    torch.cuda.synchronize()  # the context survived every refusal


def test_bf16_matmul_kernels_run_on_tensor_cores(cuda):
    """Every bf16 and f32 kernel of csrc/matmul.cu (both entries, each warp
    layout) issues HMMA, the tensor cores' instruction, in the built SASS,
    the f32 ones as TF32 products; the int8 kernels issue none."""
    functions = _build.sass("matmul")
    bf16 = [n for n in functions if matmul_ops.bf16_kernel_label(n)]
    f32 = [n for n in functions if matmul_ops.kernel_label(n)]
    assert len(bf16) == 10, sorted(functions)  # 5 warp layouts x 2 entries
    assert len(f32) == 10, sorted(functions)
    for name, body in functions.items():
        assert ("HMMA" in body) == (name in bf16 + f32), name
        assert bool(matmul_ops.HMMA_TF32.search(body)) == (name in f32), name


# The f32 kernels' shapes in chip_smoke.py's phase 2: W3 in f32, an odd
# shape, MobileNetV2 f32's 12544x32x27, 3136x24x96 and 49x1280x320, and
# DCGAN's 16x512x100 and 4096x3x256.
F32_SHAPES = [(64, 1536, 576), (100, 200, 300), (12544, 32, 27),
              (3136, 24, 96), (49, 1280, 320), (16, 512, 100),
              (4096, 3, 256)]


def _f32_check(x, w, block):
    """Both f32 entries at ``block`` on padded operands: _acc_kernel in both
    orders and at every cluster cap that changes its split, _noacc_kernel,
    each against the plain version at rtol 1e-4 / atol 1e-3. Returns the
    clusters the acc entry ran with."""
    want = matmul_plain.matmul_plain(x, w, block[2])
    rtol, atol = TOL[torch.float32]
    (pm, pk), pn = x.shape, w.shape[1]
    clusters = set()
    top = matmul_ops.F32_MAX_CLUSTER
    for order, acc, cap in (("mnk", False, top), ("nmk", True, top),
                            ("mnk", True, top), ("mnk", True, 1),
                            ("mnk", True, 2), ("mnk", True, 4)):
        if acc:
            clusters.add(matmul_ops.plan(pm, pn, pk, *block, True,
                                         cap).cluster)
        got = matmul_blocked(x, w, block, order, acc, cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{block} {order} acc={acc} "
                                   f"cap {cap}: {m}")
    return clusters


@pytest.mark.parametrize("dims", F32_SHAPES, ids=str)
def test_f32_matmul_kernels_match_plain_at_every_space_block(cuda, dims):
    """Both 3xTF32 entries at every block the H100 space offers the shape
    (padded to it as ``ops.build`` pads), K split by the rule and under
    caps 1, 2 and 4."""
    wl = W.matmul(*dims, "float32")
    x0, w0 = _operands(*dims, torch.float32, cuda)
    blocks = sorted({concretize(wl, H100, Schedule.fixed(**t)).block
                     for t in space_for(wl, H100).traces()})
    assert blocks
    for block in blocks:
        pm, pn, pk = (-(-d // b) * b for d, b in zip(dims, block))
        x = matmul_ops.pad2(x0, pm, pk).contiguous()
        w = matmul_ops.pad2(w0, pk, pn).contiguous()
        _f32_check(x, w, block)


@pytest.mark.parametrize("block", [(64, 64, 32), (80, 112, 32)],
                         ids=["2x2_tiles", "two_16x16_tiles_a_warp"])
@pytest.mark.parametrize("max_cluster", [1, 2, 4, 8])
def test_f32_cluster_cap_keeps_the_sums(cuda, max_cluster, block):
    """matmul_launch_capped: the f32 _acc_kernel with K split over at most
    ``max_cluster`` blocks (one output tile, 64 k steps, so the rule splits
    up to the cap; at 80 x 112 each warp reduces two 16x16 tiles, one
    warp's second tile absent) stays within 1e-4 / 1e-3; a cap outside
    1-8 is refused."""
    bm, bn, bk = block
    x, w = _operands(bm, bn, 64 * bk, torch.float32, cuda)
    lay = matmul_ops.plan(bm, bn, 64 * bk, *block, True, max_cluster)
    assert lay.cluster == max_cluster
    assert lay.rep == (2 if block == (80, 112, 32) else 1)
    got = matmul_blocked(x, w, block, "mnk", True, max_cluster)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, matmul_plain.matmul_plain(x, w, bk),
                               rtol=1e-4, atol=1e-3)
    for bad in (0, matmul_ops.F32_MAX_CLUSTER + 1):
        with pytest.raises(KernelLaunchError) as err:
            matmul_blocked(x, w, block, "mnk", True, bad)
        assert err.value.refused


@st.composite
def _f32_case(draw):
    """(m, n, k) up to 256 and a launchable 16-grain block."""
    m, n, k = (draw(st.integers(1, 256)) for _ in range(3))
    while True:
        block = tuple(draw(st.sampled_from([16, 32, 48, 64, 80, 112, 128]))
                      for _ in range(3))
        if matmul_ops.supports_block_shape(*block, "float32",
                                           H100.vmem_capacity):
            return (m, n, k), block


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(case=_f32_case(), seed=st.integers(0, 2**16))
def test_f32_matmul_kernels_match_plain_on_drawn_shapes(cuda, case, seed):
    """Hypothesis over (m, n, k) <= 256 and blocks: both f32 entries, every
    cluster cap that changes the split, within 1e-4 / 1e-3."""
    dims, block = case
    x0, w0 = _operands(*dims, torch.float32, cuda, seed=seed)
    pm, pn, pk = (-(-d // b) * b for d, b in zip(dims, block))
    _f32_check(matmul_ops.pad2(x0, pm, pk).contiguous(),
               matmul_ops.pad2(w0, pk, pn).contiguous(), block)


def test_launch_counts(cuda):
    kernels.reset_launch_counts()
    x, w = _operands(32, 32, 64, torch.float32, cuda)
    matmul_blocked(x, w, (16, 16, 32), accumulate=True)
    matmul_blocked(x, w, (16, 16, 32), accumulate=False)
    counts = kernels.launch_counts()
    assert counts["_acc_kernel"] == 1 and counts["_noacc_kernel"] == 1


def test_cuda_runner_tune_and_dispatch(cuda):
    wl = W.qmatmul(96, 128, 160)
    db = TuningDatabase()
    res = tune(wl, H100, CudaRunner(H100, repeats=3), trials=8, seed=0,
               database=db)
    assert np.isfinite(res.best_latency)
    params, provenance = kernel_params(wl, H100, database=db)
    assert provenance == "tuned"
    fn = kernels.build(wl, params, device="cuda")
    x, w, b = wl.example_inputs()
    got = fn(x, w, b).cpu()
    want = kernels.build(wl, params, device="cpu")(x, w, b)
    assert torch.equal(got, want)


def test_cuda_runner_invalid_block_is_inf(cuda):
    wl = W.matmul(64, 64, 64)
    runner = CudaRunner(H100, repeats=1)
    bad = Schedule.fixed(variant="mxu_64", bm=64, bn=64, bk=60, order="mnk",
                         accumulate=True)   # bk off the 16 grain
    assert not concretize(wl, H100, bad).valid
    assert runner.run(wl, bad) == float("inf")


def test_cuda_runner_clear_inputs_frees_the_operands(cuda):
    """The runner keeps each workload's operands on the card until
    ``clear_inputs``; after it they are made anew, equal, and the card
    memory they held is free."""
    wl = W.matmul(1024, 4096, 2048, "bfloat16")
    runner = CudaRunner(H100, repeats=1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    first = runner.inputs(wl)
    assert runner.inputs(wl) is first
    held = torch.cuda.memory_allocated() - before
    assert held >= sum(t.numel() * t.element_size() for t in first)
    copies = [t.clone() for t in first]
    del first
    runner.clear_inputs()
    assert torch.cuda.memory_allocated() - before == \
        sum(t.numel() * t.element_size() for t in copies)
    again = runner.inputs(wl)
    assert all(torch.equal(a, b) for a, b in zip(again, copies))


def test_cuda_runner_times_each_launch_once(cuda):
    """qmatmul blocks that the wgmma loop takes at one bn launch one kernel
    (``kernels.launch_key``): the runner times the first and hands its
    latency to the rest, and times a block of another key anew, until
    ``clear_inputs``."""
    wl = W.qmatmul(16896, 64, 576)          # 132 units of 128 rows
    runner = CudaRunner(H100, repeats=1)
    timed = []
    timer = runner._timer
    runner._timer = lambda fn, inputs: timed.append(1) or timer(fn, inputs)
    a, b, c = (Schedule.fixed(variant="mxu_64", bm=bm, bn=64, bk=bk,
                              order=order, accumulate=True)
               for bm, bk, order in ((64, 32, "mnk"), (128, 128, "nmk"),
                                     (32, 64, "mnk")))
    assert [qmatmul_ops.plan(*wl.dims, *concretize(wl, H100, s).block).path
            for s in (a, b, c)] == ["wgmma", "wgmma", "mma"]
    first = runner.run(wl, a)
    assert runner.run(wl, b) == first and len(timed) == 1
    runner.run(wl, c)
    assert len(timed) == 2
    runner.clear_inputs()
    runner.run(wl, b)
    assert len(timed) == 3


# ------------------------------------------------------- gemv and vmacc ----

def _vector_operands(n, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


def _elementwise_operands(r, c, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((r, c)).astype(
        np.float32)).to(device, dtype) for _ in range(3))


@pytest.mark.parametrize("shape,block", [
    ((32000, 576), (128, 64)),     # the MobileLLM-125M LM head
    ((960, 576), (16, 576)),       # QKV, one k step
    ((576, 1536), (64, 96)),
    ((112, 320), (1, 32)),         # the J = 1 row kernel
    ((2048, 64), (1024, 16)),      # the widest block
    # every bn the H100 space offers MobileLLM-125M's decode step, narrow n
    ((960, 576), (16, 96)), ((960, 576), (32, 192)), ((960, 576), (48, 48)),
    ((960, 576), (80, 288)), ((960, 576), (96, 64)), ((640, 1536), (128, 384)),
    ((576, 1536), (16, 16)),       # bk 16: 96 k steps
    ((576, 2048), (16, 1024)),     # bk 1024, k 1536 padded to 2048
    ((640, 2048), (128, 1024)),
    ((101, 304), (1, 16)),         # J = 1 at odd pn: rows not 16-byte aligned
    # _gemv_kernel's cluster (ops.plan): 131 column blocks split K over 2
    # blocks, 132 do not; one column block splits K over 4 (bf16) or 8
    # (f32) blocks, or over none (bf16) or 2 (f32) when k is short
    ((2096, 2304), (16, 64)), ((2112, 2304), (16, 64)),
    ((16, 4096), (16, 16)), ((16, 1024), (16, 16)),
    ((576, 1536), (16, 256)),      # N1's down projection, 2-block clusters
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("accumulate", [True, False])
def test_gemv_kernels_match_plain(cuda, shape, block, dtype, accumulate):
    n, k = shape
    x, w = _vector_operands(n, k, dtype, cuda)
    got = gemv_blocked(x, w, block, accumulate)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (1, n)
    # bf16 products are exact in f32: both dtypes differ by sum order only
    torch.testing.assert_close(got, gemv_plain.gemv_plain(x, w, block[1]),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("max_cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_cluster_cap_keeps_the_sums(cuda, max_cluster, dtype):
    """gemv_launch_capped: _gemv_kernel with K split over at most
    ``max_cluster`` blocks (one column block, so the rule splits up to the
    cap) equals the plain version; a cap outside 1-8 is refused."""
    x, w = _vector_operands(16, 8192, dtype, cuda)
    got = gemv_blocked(x, w, (16, 16), True, max_cluster)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gemv_plain.gemv_plain(x, w, 16),
                               rtol=1e-4, atol=1e-3)
    assert gemv_ops.plan(16, 8192, 16, 16, "bfloat16" if dtype ==
                         torch.bfloat16 else "float32", True,
                         max_cluster).cluster == max_cluster
    for bad in (0, gemv_ops.MAX_CLUSTER + 1):
        with pytest.raises(KernelLaunchError) as err:
            gemv_blocked(x, w, (16, 16), True, bad)
        assert err.value.refused


def test_gemv_vector_kernels_issue_128_bit_loads(cuda):
    """The kernels with 16-byte vectors (both dtypes, both entries) read w
    with 128-bit global loads in the built SASS."""
    functions = {gemv_ops.kernel_label(name): body
                 for name, body in _build.sass("gemv").items()
                 if gemv_ops.kernel_label(name)}
    assert len(functions) == 8, sorted(functions)  # 2 dtypes x V x 2 entries
    vector = [label for label in functions if ",1," not in label]
    assert len(vector) == 4
    for label in vector:
        assert gemv_ops.LDG_128.search(functions[label]), label


@pytest.mark.parametrize("shape,block", [
    ((12544, 32), (32, 32)),       # MobileNetV2's first depthwise stage
    ((64, 1024), (16, 128)),       # 49 x 960, padded to the block
    ((3136, 96), (16, 16)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmacc_kernel_matches_plain(cuda, shape, block, dtype):
    a, b, c = _elementwise_operands(*shape, dtype, cuda)
    got = vmacc_blocked(a, b, c, block)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # f32: one fused multiply-add against a rounded product; bf16: the
    # kernel rounds as the two eager operations do
    tol = 1e-5 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(got, vmacc_plain.vmacc_plain(a, b, c),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_gemv_gate_matches_kernel_thread_limit(cuda, inside):
    """A block's 256 threads cover at most 256 16-byte vectors of columns,
    1024 f32 columns (bf16 is held to the same limit): the gate and the
    kernel's own check agree on both sides of the limit."""
    bn = gemv_ops.MAX_BN if inside else gemv_ops.MAX_BN + 16
    assert gemv_ops.supports_block_shape(bn, 16, 16) is inside
    x, w = _vector_operands(bn, 32, torch.float32, cuda)
    if not inside:
        with pytest.raises(KernelLaunchError) as err:
            gemv_blocked(x, w, (bn, 16))
        assert err.value.refused
    else:
        got = gemv_blocked(x, w, (bn, 16))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, gemv_plain.gemv_plain(x, w, 16),
                                   rtol=1e-4, atol=1e-3)
    torch.cuda.synchronize()  # the context survived


@pytest.mark.parametrize("op,block,inside", [
    ("gemv", (16, 16), True), ("gemv", (16, 24), False),      # bk lane
    ("gemv", (1, 16), True), ("gemv", (8, 16), False),        # bn: 1 or lane
    ("vmacc", (16, 16), True), ("vmacc", (8, 16), False),     # br sublane
    ("vmacc", (16, 32), True), ("vmacc", (16, 24), False),    # bc lane
])
def test_design_space_gates_on_both_sides(cuda, op, block, inside):
    """The reference's lane and sublane rules (no limit of the CUDA
    kernels): a block inside them is a valid H100 candidate and runs right
    on the card; one step beyond is INVALID before it reaches the card."""
    dims = (96, 48)
    wl = W.gemv(*dims) if op == "gemv" else W.vmacc(*dims)
    variant = "vl_16" if op == "gemv" else "vl_min"
    key = ("bn", "bk") if op == "gemv" else ("br", "bc")
    decisions = dict(zip(key, block), variant=variant)
    if op == "gemv":
        decisions["accumulate"] = True
    params = concretize(wl, H100, Schedule.fixed(**decisions))
    assert params.valid is inside, params.why_invalid
    if inside:
        inputs = wl.example_inputs()
        got = kernels.build(wl, params, device="cuda")(*inputs).cpu()
        want = kernels.build(wl, params, device="cpu")(*inputs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_new_kernels_count_launches(cuda):
    kernels.reset_launch_counts()
    x, w = _vector_operands(64, 64, torch.float32, cuda)
    gemv_blocked(x, w, (16, 32), accumulate=True)
    gemv_blocked(x, w, (16, 32), accumulate=False)
    vmacc_blocked(*_elementwise_operands(16, 16, torch.float32, cuda),
                  (16, 16))
    counts = kernels.launch_counts()
    assert counts["_gemv_kernel"] == counts["_gemv_noacc_kernel"] == 1
    assert counts["_vmacc_kernel"] == 1


def test_interleaved_cuda_session_tunes_gemv_and_vmacc(cuda):
    """A session on the card at pipeline depth 2: measured by the
    scheduler's thread, every workload tuned, outputs equal to the plain
    versions'."""
    runner = CudaRunner(H100, repeats=2, warmup=1)
    assert effective_pipeline_depth(runner, 2) == 2
    ops = [(2, W.gemv(960, 576, "bfloat16")), (9, W.vmacc(49, 960)),
           (1, W.qmatmul(49, 96, 576))]
    db = TuningDatabase()
    res = TuningSession(H100, runner, database=db,
                        pipeline_depth=2).tune_model(ops, total_trials=24,
                                                     seed=0)
    assert res.interleaved and res.pipeline_depth == 2
    for _, wl in ops:
        params, provenance = kernel_params(wl, H100, database=db)
        assert provenance == "tuned"
        inputs = wl.example_inputs()
        got = kernels.build(wl, params, device="cuda")(*inputs).cpu()
        want = kernels.build(wl, params, device="cpu")(*inputs)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-4,
                                   atol=1e-3)


def test_interleaved_cuda_session_raises_on_kernel_fault(cuda, monkeypatch):
    """A fault in a kernel launched from the measurement thread is not
    swallowed there: the session raises it in the tuning thread."""
    real_build = kernels.build

    def faulty_build(workload, params, device="cuda", cache=None):
        fn = real_build(workload, params, device=device, cache=cache)
        if workload.op != "vmacc":
            return fn

        def fault(*inputs):
            raise KernelLaunchError("_vmacc_kernel", 700,
                                    "an illegal memory access was "
                                    "encountered")
        return fault

    monkeypatch.setattr(kernels, "build", faulty_build)
    ops = [(1, W.gemv(576, 576)), (1, W.vmacc(64, 128))]
    session = TuningSession(H100, CudaRunner(H100, repeats=1, warmup=0),
                            pipeline_depth=2)
    with pytest.raises(KernelLaunchError) as err:
        session.tune_model(ops, total_trials=8, seed=0)
    assert not err.value.refused


@pytest.mark.parametrize("wl", [W.qmatmul(12544, 32, 27),
                                W.qmatmul(784, 144, 24),
                                W.qmatmul(3136, 24, 96),
                                W.qmatmul(1, 1000, 1280),
                                W.qmatmul(3136, 64, 576)],
                         ids=lambda w: w.key())
def test_int8_library_call_takes_the_networks_shapes(cuda, wl):
    """The library yardstick pads what ``torch._int_mm`` refuses (k = 27
    and 24, n = 24, a single row) and equals the oracle exactly."""
    inputs = tuple(t.to(cuda) for t in map(torch.from_numpy,
                                           wl.example_inputs()))
    got = kernels.baseline(wl)(*inputs)
    assert torch.equal(got, kernels.reference(wl)(*inputs))


def test_measurement_thread_launches_on_device0_default_stream(cuda):
    """The scheduler's measurement thread launches on the default stream of
    device 0, the stream ``CardTimer`` records its events on."""
    from repro_torch.core import MeasureScheduler

    seen = []

    class Probe(CudaRunner):
        def run_batch(self, workload, schedules):
            seen.append((torch.cuda.current_device(),
                         torch.cuda.current_stream()))
            return super().run_batch(workload, schedules)

    runner = Probe(H100, repeats=1, warmup=0)
    wl = W.vmacc(64, 128)
    sched = MeasureScheduler(runner)
    try:
        sched.submit(0, wl, [Schedule.fixed(variant="vl_min", br=16,
                                            bc=128)])
        _, _, latencies, _, _ = sched.collect_next()
    finally:
        sched.close()
    assert np.isfinite(latencies[0])
    assert seen == [(0, torch.cuda.default_stream(0))]


# -------------------------------------------------------------- attention ----

# tests/test_kernels.py:141, for f32 and bf16 outputs alike
FA_TOL = 2e-3


def _fa_check(wl, params, q_scale=1.0):
    """``_fa_kernel`` against its plain version on the same padded device
    operands (every row, padding included), q scaled by ``q_scale``."""
    assert params.valid, params.why_invalid
    q, k, v = wl.example_inputs()
    q, k, v = fa_ops.pad_operands(params, q * q_scale, k, v, "cuda")
    got = flash_attention_blocked(q, k, v, params)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), fa_plain_version(q, k, v,
                                                             params).float(),
                               rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.parametrize("dims,causal,dtype,variant", [
    ((1, 2, 2, 64, 64, 64), False, "float32", "fa_128x128"),  # BERT-tiny
    ((1, 9, 3, 64, 64, 64), True, "float32", "fa_64x64"),     # MobileLLM
    ((1, 9, 3, 64, 64, 64), True, "float32", "fa_16x16"),     # smallest rung
    ((1, 9, 3, 64, 64, 64), True, "bfloat16", "fa_64x32"),
    ((2, 4, 2, 64, 64, 32), True, "float32", "fa_32x64"),
    ((1, 2, 1, 17, 33, 8), True, "float32", "fa_16x16"),      # ragged
    ((1, 2, 1, 33, 17, 8), True, "float32", "fa_16x16"),      # no visible key
    ((1, 2, 1, 33, 17, 8), True, "float32", "fa_64x64"),
    ((1, 9, 3, 512, 512, 64), True, "float32", "fa_128x128"),  # largest rung
    ((1, 9, 3, 512, 512, 64), True, "bfloat16", "fa_128x128"),
])
def test_fa_kernel_matches_plain(cuda, dims, causal, dtype, variant):
    wl = W.attention(*dims, dtype, causal=causal)
    _fa_check(wl, concretize(wl, H100, Schedule.fixed(variant=variant)))


@pytest.mark.parametrize("dims,causal,variant", [
    ((1, 2, 2, 64, 64, 64), False, "fa_16x16"),      # BERT-tiny
    ((1, 9, 3, 64, 64, 64), True, "fa_16x16"),       # MobileLLM
    ((1, 9, 3, 512, 512, 64), True, "fa_128x128"),
    ((1, 2, 1, 33, 17, 8), True, "fa_16x16"),        # no visible key
])
def test_fa_kernel_matches_plain_on_peaked_scores(cuda, dims, causal,
                                                   variant):
    """q scaled 16x: scores of standard deviation ~4 instead of ~0.25, so
    the running max moves between KV blocks and the alpha rescale and the
    exp path carry the result."""
    wl = W.attention(*dims, causal=causal)
    _fa_check(wl, concretize(wl, H100, Schedule.fixed(variant=variant)),
              q_scale=16.0)


def _fa_params(pd, dtype):
    """One (128, 128) block of a single head at padded head dim ``pd``."""
    dims = (1, 1, 1, 128, 128, pd)
    return KernelParams("attention", dims, dims, (128, 128), (1, 1, 1),
                        "qk_causal", True, dtype, dtype,
                        fa_ops.smem_bytes(128, 128, pd, dtype), True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_fa_gate_matches_kernel_limits(cuda, dtype, inside):
    """The Python gate (``flash_attention.ops.supports_block_shape``) and
    the kernel's own shared-memory request agree on both sides of the
    H100's limit: the largest head dim (a multiple of 16, the kernel's
    grain) the gate accepts for a (128, 128) block launches and is right,
    the next one is refused by the card."""
    pd = 16
    while fa_ops.supports_block_shape(128, 128, pd + 16, dtype,
                                      H100.vmem_capacity):
        pd += 16
    if not inside:
        pd += 16
    assert fa_ops.supports_block_shape(128, 128, pd, dtype,
                                       H100.vmem_capacity) is inside
    assert (fa_ops.smem_bytes(128, 128, pd, dtype)
            <= H100.vmem_capacity) is inside
    params = _fa_params(pd, dtype)
    wl = W.attention(*params.dims, dtype)
    if inside:
        _fa_check(wl, params)
    else:
        q, k, v = fa_ops.pad_operands(params, *wl.example_inputs(), "cuda")
        with pytest.raises(KernelLaunchError) as err:
            flash_attention_blocked(q, k, v, params)
        assert err.value.refused
    torch.cuda.synchronize()  # the context survived


# The attention workloads the main paths tune: BERT-tiny (N3) and
# MobileLLM-125M (N4) at seq 64, and both at their published max_seq_len
# (N8: 512 and 2048).
FA_NETWORK_DIMS = [(1, 2, 2, 64, 64, 64), (1, 9, 3, 64, 64, 64),
                   (1, 2, 2, 512, 512, 64), (1, 9, 3, 2048, 2048, 64)]


def _space_blocks(wl):
    """Every (bq, bkv) block the workload's H100 space offers, as params."""
    found = {}
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        found.setdefault(p.block, p)
    return [found[b] for b in sorted(found)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dims", FA_NETWORK_DIMS, ids=str)
def test_fa_kernel_matches_plain_at_every_space_block(cuda, dims, causal,
                                                      dtype):
    """``_fa_kernel`` at every block of the H100 space of N3's, N4's and
    N8's attention shapes, causal and not, f32 and bf16, against its plain
    version at 2e-3 (split and unsplit KV columns, every register class
    the networks reach)."""
    wl = W.attention(*dims, dtype, causal=causal)
    params = _space_blocks(wl)
    assert len(params) == (9 if dims[3] == 64 else 16)
    assert {fa_ops.plan(*p.block, p.padded_dims[5]).wk for p in params} \
        == {1, 2, 4}
    for p in params:
        _fa_check(wl, p)


@pytest.mark.parametrize("dims,causal,dtype", [
    ((1, 2, 1, 17, 33, 8), True, "float32"),     # ragged
    ((1, 2, 1, 17, 33, 8), True, "bfloat16"),
    ((1, 2, 1, 33, 17, 8), True, "float32"),     # no visible key
    ((1, 2, 1, 33, 17, 8), True, "bfloat16"),
    ((1, 3, 1, 40, 72, 136), True, "float32"),   # head dim class 256
    ((1, 2, 2, 48, 80, 96), False, "bfloat16"),  # head dim class 128
])
def test_fa_kernel_matches_plain_on_ragged_shapes(cuda, dims, causal, dtype):
    """Ragged lengths and head dims, and the no-visible-key rows, at every
    block of the shape's H100 space."""
    wl = W.attention(*dims, dtype, causal=causal)
    for p in _space_blocks(wl):
        _fa_check(wl, p)


@pytest.mark.parametrize("dims,causal,variant", [
    ((1, 2, 2, 512, 512, 64), False, "fa_16x64"),
    ((1, 9, 3, 2048, 2048, 64), True, "fa_64x64"),
    ((1, 9, 3, 2048, 2048, 64), True, "fa_16x128"),
])
def test_fa_kernel_matches_plain_on_peaked_scores_at_max_seq(cuda, dims,
                                                             causal, variant):
    """q scaled 16x at the N8 shapes: 3xTF32 holds exp(s - m) within 2e-3
    of the plain version where the scores are peaked."""
    wl = W.attention(*dims, causal=causal)
    _fa_check(wl, concretize(wl, H100, Schedule.fixed(variant=variant)),
              q_scale=16.0)


def _bf16_half_ulp(y):
    """Half a bf16 unit in the last place at |y| (8 significand bits)."""
    _, e = torch.frexp(y.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(y), e - 9)


@pytest.mark.parametrize("dims,causal,variant", [
    ((1, 9, 3, 64, 64, 64), True, "fa_16x64"),
    ((1, 2, 2, 512, 512, 64), False, "fa_16x64"),
    ((1, 9, 3, 2048, 2048, 64), True, "fa_64x64"),
])
def test_fa_kernel_bf16_on_peaked_scores_is_a_rounding_of_plain(
        cuda, dims, causal, variant):
    """bf16 on peaked scores (q scaled 16x): outputs are single v rows of
    magnitude up to ~2, where one bf16 unit (2^-8 to 2^-7) exceeds 2e-3, so
    two computations that differ in f32 by 1e-6 may round apart. The
    kernel's bf16 output is the bf16 rounding of a value within 2e-3 of the
    plain version's f32 result on the same bf16 operands (the plain
    version's arithmetic before its cast to bf16)."""
    wl = W.attention(*dims, "bfloat16", causal=causal)
    params = concretize(wl, H100, Schedule.fixed(variant=variant))
    q, k, v = wl.example_inputs()
    q, k, v = fa_ops.pad_operands(params, q * 16.0, k, v, "cuda")
    got = flash_attention_blocked(q, k, v, params).float()
    want = fa_plain_version(q.float(), k.float(), v.float(), params)
    torch.cuda.synchronize()
    bound = FA_TOL + FA_TOL * want.abs() + _bf16_half_ulp(got)
    assert bool(torch.all((got - want).abs() <= bound)), \
        float(((got - want).abs() - bound).max())


@pytest.mark.parametrize("variant", ["fa_16x64", "fa_32x128", "fa_128x64"])
def test_fa_kernel_is_the_same_from_run_to_run(cuda, variant):
    """The cross-warp combine runs in a fixed order: two launches on the
    same operands give the same bits (split blocks and an unsplit one)."""
    wl = W.attention(1, 9, 3, 2048, 2048, 64)
    params = concretize(wl, H100, Schedule.fixed(variant=variant))
    q, k, v = fa_ops.pad_operands(params, *wl.example_inputs(), "cuda")
    first = flash_attention_blocked(q, k, v, params)
    second = flash_attention_blocked(q, k, v, params)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fa_kernels_run_on_tensor_cores(cuda):
    """Every kernel of csrc/flash_attention.cu (f32 and bf16, each head-dim
    register class and sub-tile width) issues HMMA, the f32 ones as TF32
    products."""
    functions = {fa_ops.kernel_label(name): body
                 for name, body in _build.sass("flash_attention").items()
                 if fa_ops.kernel_label(name)}
    assert sorted(functions) == sorted(fa_ops.kernel_labels())
    for label, body in functions.items():
        assert fa_ops.HMMA.search(body), label
        if "f32" in label:
            assert matmul_ops.HMMA_TF32.search(body), label


def test_cuda_runner_tunes_attention(cuda):
    """MobileLLM-125M's prefill attention tuned on the card: every trial
    measured (no rung is refused at head dim 64), dispatch resolves the
    tuned schedule, its output equals the plain version's, and the kernel
    was launched and counted."""
    wl = W.attention(1, 9, 3, 64, 64, 64)
    db = TuningDatabase()
    kernels.reset_launch_counts()
    res = tune(wl, H100, CudaRunner(H100, repeats=3), trials=8, seed=0,
               database=db)
    assert all(np.isfinite(lat) for _, lat in res.history)
    assert kernels.launch_counts()["_fa_kernel"] > 0
    params, provenance = kernel_params(wl, H100, database=db)
    assert provenance == "tuned"
    inputs = wl.example_inputs()
    got = kernels.build(wl, params, device="cuda")(*inputs).cpu()
    want = kernels.build(wl, params, device="cpu")(*inputs)
    torch.testing.assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.parametrize("dims,causal", [((1, 9, 3, 64, 64, 64), True),
                                         ((1, 2, 1, 33, 17, 8), True),
                                         ((1, 2, 2, 64, 64, 64), False)])
def test_attention_library_call_matches_oracle(cuda, dims, causal):
    """The SDPA yardstick (bottom-right causal mask, grouped heads) equals
    the oracle on the card, TF32 off."""
    wl = W.attention(*dims, causal=causal)
    inputs = tuple(torch.from_numpy(a).to(cuda) for a in wl.example_inputs())
    torch.testing.assert_close(kernels.baseline(wl)(*inputs),
                               kernels.reference(wl)(*inputs), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------- qmatmul and vmacc, unpadded ----

def _at_offset(t, offset):
    """A contiguous copy of ``t`` whose storage starts ``offset`` elements
    into a larger buffer: its data_ptr() is off the 16-byte grain."""
    buf = torch.zeros(t.numel() + offset + 16, dtype=t.dtype,
                      device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _qmm_operands(m, n, k, device, seed=1):
    x, w = _operands(m, n, k, torch.int8, device, seed=seed)
    bias = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        -1000, 1000, n).astype(np.int32)).to(device)
    return x, w, bias


# MobileNetV2 int8 (N2), MobileLLM-125M int8 prefill (N4), W1 and W2
QMM_SHAPES = [(12544, 32, 27), (784, 144, 24), (3136, 24, 96),
              (49, 160, 576), (1, 1000, 1280), (64, 576, 1536),
              (3136, 64, 576), (64, 32000, 576)]


@pytest.mark.parametrize("dims", QMM_SHAPES, ids=str)
@pytest.mark.parametrize("max_cluster", [None, 1], ids=["rule", "no_split"])
def test_qmatmul_ragged_matches_plain(cuda, dims, max_cluster):
    """The unpadded entry at every block the H100 space offers the shape,
    with K split by the kernel's rule and over no cluster: bit-exact
    against the plain version on the same unpadded operands."""
    wl = W.qmatmul(*dims)
    x, w, bias = _qmm_operands(*dims, cuda)
    blocks = sorted({concretize(wl, H100, Schedule.fixed(**t)).block
                     for t in space_for(wl, H100).traces()})
    for block in blocks:
        got = qmatmul_ragged(x, w, bias, 0.01, block, max_cluster)
        torch.cuda.synchronize()
        assert got.shape == dims[:2]
        assert torch.equal(got, qmatmul_plain.qmatmul_plain(
            x, w, bias, 0.01, block[2])), block


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (8, 4), (4, 8), (2, 2)])
@pytest.mark.parametrize("dims", [(64, 576, 1536), (49, 160, 576),
                                  (33, 65, 17)], ids=str)
def test_qmatmul_ragged_alignment_paths(cuda, offsets, dims):
    """Operands whose storage starts off the 16-byte grain take narrower
    copies (8, 4 bytes, or byte loads: ops.copy_width) and stay exact."""
    x, w, bias = _qmm_operands(*dims, cuda)
    x, w = _at_offset(x, offsets[0]), _at_offset(w, offsets[1])
    m, n, k = dims
    p = qmatmul_ops.plan(m, n, k, 32, 64, 64, x.data_ptr(), w.data_ptr())
    assert p.vx == qmatmul_ops.copy_width(k, x.data_ptr()) <= 16
    got = qmatmul_ragged(x, w, bias, 0.01, (32, 64, 64))
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_plain.qmatmul_plain(x, w, bias, 0.01,
                                                        64))


@pytest.mark.parametrize("max_cluster", [1, 2, 4, 8])
def test_qmatmul_cluster_cap_keeps_the_sums(cuda, max_cluster):
    """qmatmul_launch_capped: K split over at most ``max_cluster`` blocks
    (one output tile, 64 k steps, so the rule splits up to the cap) is
    exact; a cap outside 1-8 is refused."""
    x, w, bias = _qmm_operands(40, 60, 2048, cuda)
    block = (64, 64, 32)
    assert qmatmul_ops.plan(40, 60, 2048, *block,
                            max_cluster=max_cluster).cluster == max_cluster
    got = qmatmul_ragged(x, w, bias, 0.01, block, max_cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_plain.qmatmul_plain(x, w, bias, 0.01,
                                                        32))
    for bad in (0, qmatmul_ops.MAX_CLUSTER + 1):
        with pytest.raises(KernelLaunchError) as err:
            qmatmul_ragged(x, w, bias, 0.01, block, bad)
        assert err.value.refused


def _qmm_gate_boundary(limit):
    """Blocks just inside and one step beyond one limit of
    ``qmatmul.ops.supports_block_shape`` at the H100's shared memory."""
    if limit == "grain_m":
        return (16, 32, 32), (24, 32, 32)
    if limit == "grain_n":
        return (16, 32, 32), (16, 48, 32)
    if limit == "grain_k":
        return (16, 32, 32), (16, 32, 48)
    if limit == "outputs":                       # bm * bn <= 16384
        return (128, 128, 32), (128, 160, 32)
    bk = 32                                      # shared memory
    while qmatmul_ops.supports_block_shape(16, 32, bk + 32,
                                           H100.vmem_capacity):
        bk += 32
    return (16, 32, bk), (16, 32, bk + 32)


@pytest.mark.parametrize("limit", ["grain_m", "grain_n", "grain_k",
                                   "outputs", "smem"])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_qmatmul_gate_matches_kernel_limits(cuda, limit, inside):
    """The Python gate and the launcher's own checks agree on both sides of
    every limit: a block the gate accepts launches and is exact (one block
    of operands, both entries), one step beyond it the card refuses."""
    block = _qmm_gate_boundary(limit)[0 if inside else 1]
    assert qmatmul_ops.supports_block_shape(
        *block, H100.vmem_capacity) is inside
    bm, bn, bk = block
    x, w, bias = _qmm_operands(bm, bn, bk, cuda)
    for call in (qmatmul_blocked, qmatmul_ragged):
        if not inside:
            with pytest.raises(KernelLaunchError) as err:
                call(x, w, bias, 0.01, block)
            assert err.value.refused
            continue
        got = call(x, w, bias, 0.01, block)
        torch.cuda.synchronize()
        assert torch.equal(got, qmatmul_plain.qmatmul_plain(x, w, bias,
                                                            0.01, bk))
    torch.cuda.synchronize()  # the context survived every refusal


def test_qmatmul_kernels_run_on_tensor_cores(cuda):
    """Every kernel of csrc/qmatmul.cu issues an integer tensor-core
    instruction in the built SASS: IMMA in each warp layout of the mma.sync
    loop, IGMMA in each n of the wgmma loop."""
    functions = {qmatmul_ops.kernel_label(name): body
                 for name, body in _build.sass("qmatmul").items()
                 if qmatmul_ops.kernel_label(name)}
    assert sorted(functions) == sorted(
        ["qmm_kernel<1,1>", "qmm_kernel<1,2>", "qmm_kernel<2,1>",
         "qmm_kernel<2,2>"]
        + [f"wgmma::qmm_kernel<{n}>" for n in range(32, 129, 32)])
    for label, body in functions.items():
        assert qmatmul_ops.census_fault(label, body) is None, label


# The wgmma loop at the cells' shapes: ResNet18's conv1 (K 147: x by bulk
# copies, re-laid), conv2_x, conv3_x and conv5_x (at bn 32, its w slice
# resident); MobileNetV2's K 27 / N 32, K 16 / N 96 and K 24 / N 144; and
# tails: a ragged M with N 1000, a bulk K of 100 at 128 rows, bn 128 and
# 96 over an N tail, an odd number of units a block.
WGMMA_CASES = [
    ((802816, 64, 147), (64, 64, 64)),
    ((200704, 64, 576), (64, 64, 64)),
    ((50176, 128, 1152), (128, 128, 128)),
    ((3136, 512, 4608), (64, 32, 64)),
    ((1204224, 32, 27), (64, 32, 32)),
    ((1204224, 96, 16), (64, 96, 32)),
    ((301056, 144, 24), (64, 64, 32)),
    ((8513, 1000, 64), (64, 32, 64)),
    ((9000, 200, 100), (128, 64, 32)),
    ((20000, 256, 320), (64, 128, 64)),
    ((20000, 800, 320), (64, 96, 96)),
    ((16896 + 128, 64, 64), (64, 64, 64)),
]


@pytest.mark.parametrize("dims,block", WGMMA_CASES, ids=str)
def test_qmatmul_wgmma_loop_is_exact(cuda, dims, block):
    """Each shape takes the wgmma loop (the launcher says so, the counter
    moves) and is bit-exact against the plain version; with x at an 8-byte
    but not 16-byte address the same call keeps the mma.sync loop, exact
    too, and the counter stays."""
    x, w, bias = _qmm_operands(*dims, cuda)
    assert qmatmul_ops.plan(*dims, *block, x.data_ptr(),
                            w.data_ptr()).path == "wgmma"
    want = qmatmul_plain.qmatmul_plain(x, w, bias, 0.01, block[2])
    kernels.reset_launch_counts()
    got = qmatmul_ragged(x, w, bias, 0.01, block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert counts["_qmm_kernel"] == counts["_qmm_kernel.wgmma"] == 1
    x8 = _at_offset(x, 8)
    assert x8.data_ptr() % 16 == 8
    assert qmatmul_ops.plan(*dims, *block, x8.data_ptr(),
                            w.data_ptr()).path == "mma"
    got = qmatmul_ragged(x8, w, bias, 0.01, block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert (counts["_qmm_kernel"], counts["_qmm_kernel.wgmma"]) == (2, 1)


@pytest.mark.parametrize("dims,block", [
    ((3136, 64, 576), (64, 64, 64)),      # W1: 49 tiles
    ((64, 32000, 576), (64, 64, 64)),     # W2: 500 columns of tiles
    ((64, 576, 1536), (64, 64, 64)),      # N4's projection
    ((96, 1000, 1280), (64, 64, 64)),     # MobileNetV2's classifier
    ((200704, 64, 576), (32, 64, 64)),    # 32-row blocks
    ((20000, 256, 320), (64, 256, 64)),   # bn past 128
], ids=["w1", "w2", "n4", "classifier", "bm32", "bn256"])
def test_qmatmul_wgmma_counter_stays_off_the_rule(cuda, dims, block):
    """Where the rule keeps the mma.sync loop the launch is counted once,
    never as a wgmma one."""
    x, w, bias = _qmm_operands(*dims, cuda)
    assert qmatmul_ops.plan(*dims, *block).path == "mma"
    kernels.reset_launch_counts()
    got = qmatmul_ragged(x, w, bias, 0.01, block)
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_plain.qmatmul_plain(x, w, bias, 0.01,
                                                        block[2]))
    counts = kernels.launch_counts()
    assert (counts["_qmm_kernel"], counts["_qmm_kernel.wgmma"]) == (1, 0)


@pytest.mark.parametrize("shape,block", [
    ((196, 192), (16, 128)), ((196, 192), (32, 16)),   # N2, 14 x 14
    ((49, 960), (16, 128)), ((49, 960), (32, 64)),      # N2, 7 x 7
    ((12544, 32), (16, 32)),                            # N2's first stage
    ((33, 17), (16, 16)), ((33, 17), (1, 1)),           # the scalar path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
def test_vmacc_ragged_matches_plain(cuda, shape, block, dtype, offset):
    """The unpadded entry against the plain version: f32 within 1e-5 (one
    fma against a rounded product), bf16 exact; a view at an odd offset
    takes the scalar path (ops.plan)."""
    a, b, c = (_at_offset(t, offset)
               for t in _elementwise_operands(*shape, dtype, cuda))
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, c))
    assert aligned == (offset == 0)
    vec = 16 // a.element_size()
    p = vmacc_ops.plan(*shape, *block, _GATE_DTYPE[dtype], aligned)
    assert (p.v > 1) == (aligned and shape[1] % vec == 0
                         and block[1] % vec == 0)
    got = vmacc_ragged(a, b, c, block)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape
    tol = 1e-5 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(got, vmacc_plain.vmacc_plain(a, b, c),
                               rtol=tol, atol=tol)


def test_vmacc_vector_kernels_issue_128_bit_loads(cuda):
    """The vector kernels of csrc/vmacc.cu (f32 and bf16) read with 128-bit
    global loads in the built SASS; the scalar ones exist beside them."""
    functions = {vmacc_ops.kernel_label(name): body
                 for name, body in _build.sass("vmacc").items()
                 if vmacc_ops.kernel_label(name)}
    assert sorted(functions) == ["vmacc_kernel<bfloat16,1>",
                                 "vmacc_kernel<bfloat16,8>",
                                 "vmacc_kernel<float32,1>",
                                 "vmacc_kernel<float32,4>"]
    for label in ("vmacc_kernel<bfloat16,8>", "vmacc_kernel<float32,4>"):
        assert gemv_ops.LDG_128.search(functions[label]), label


@pytest.mark.parametrize("wl", [W.qmatmul(12544, 32, 27), W.vmacc(196, 192),
                                W.qmatmul(1, 1000, 1280), W.vmacc(33, 17)],
                         ids=lambda w: w.key())
def test_build_launches_one_kernel_and_pads_nothing(cuda, wl):
    """One call of the built op on device inputs launches the kernel once
    and nothing else (torch.profiler counts the card's kernels) and equals
    the plain version of the same schedule."""
    params = concretize(wl, H100, Schedule.fixed(
        **next(iter(space_for(wl, H100).traces()))))
    inputs = tuple(torch.from_numpy(a).to(cuda) for a in wl.example_inputs())
    fn = kernels.build(wl, params, cache=False)
    fn(*inputs)                                # build and load first
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = fn(*inputs)
        torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 1
    device_kernels = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_kernels) == 1, [e.name for e in device_kernels]
    want = kernels.build(wl, params, device="cpu")(*wl.example_inputs())
    tol = 0.0 if wl.op == "qmatmul" else 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


# ------------------------------------------------------ the serving path ----

@pytest.fixture(scope="module")
def mobilellm():
    """MobileLLM-125M unreduced (bf16 compute on f32 master weights) on the
    card, its bundle and 64-token batch-1 prompts."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build

    cfg = get_config("mobilellm_125m")
    bundle = build(cfg, remat="none")
    params = bundle.init(torch.Generator().manual_seed(0))
    prompts = bundle.make_batch(0, ShapeSpec("serve", 64, 1, "decode"),
                                train=False)["tokens"]
    return cfg, bundle, params, prompts


def _server(mobilellm, **kwargs):
    from repro_torch.core import TrafficLog
    from repro_torch.runtime.serve_loop import Server, decode_ops

    cfg, bundle, params, _ = mobilellm
    ops = decode_ops(cfg, 1)
    kwargs.setdefault("database", TuningDatabase())
    kwargs.setdefault("traffic", TrafficLog())
    return Server(bundle, params, max_len=64 + 8 + 1, hw=H100,
                  serve_ops=ops, **kwargs), ops


def test_server_provenance_round_trip_at_full_width(cuda, mobilellm):
    """Cold: every one of the 151 decode-step ops "fixed" and the five
    shapes in the traffic log; one ContinuousTuner cycle on CudaRunner;
    then every op "tuned", and the tokens unchanged (dispatch does not
    touch the model's arithmetic)."""
    from repro_torch.core import ContinuousTuner

    prompts = mobilellm[3]
    server, ops = _server(mobilellm)
    cold = server.generate(prompts, 8)
    assert cold.dispatch == {"fixed": 151}
    assert sorted(e.hits for e in server.traffic.hottest()) == \
        [1, 30, 30, 30, 60]
    ContinuousTuner(server.traffic, H100, runner=CudaRunner(H100),
                    database=server.database, trials_per_shape=4,
                    max_shapes_per_cycle=len(ops)).tune_once()
    warm = server.generate(prompts, 8)
    assert warm.dispatch == {"tuned": 151}
    assert len(server.traffic) == 0
    np.testing.assert_array_equal(warm.tokens, cold.tokens)
    assert warm.tokens.shape == (1, 72)


def test_server_steady_state_builds_nothing(cuda, mobilellm):
    from repro_torch.core import build_cache_stats

    server, _ = _server(mobilellm, build_kernels=True)
    server.generate(mobilellm[3], 2)
    mid = build_cache_stats()
    server.generate(mobilellm[3], 2)
    after = build_cache_stats()
    assert after["misses"] == mid["misses"]
    assert after["hits"] - mid["hits"] == 5


def test_server_build_failure_raises(cuda, mobilellm, monkeypatch, tmp_path):
    """A kernel that fails to build on the card (here: nvcc exits nonzero
    into an empty build directory) makes generate raise; it is not skipped
    as the JAX package's server skips every build exception."""
    from repro_torch.core import clear_build_cache

    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    clear_build_cache()
    server, _ = _server(mobilellm, build_kernels=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        server.generate(mobilellm[3], 2)
    clear_build_cache()


@pytest.mark.parametrize("batch", [1, 4])
def test_serving_tuned_schedules_match_plain(cuda, batch):
    """MobileLLM-125M's decode shapes at batch 1 (bf16 gemv) and batch 4
    (bf16 matmul at four rows), recorded at dispatch and tuned by one
    ContinuousTuner cycle on CudaRunner: each resolves "tuned", and its
    kernel's output on the card equals the same schedule's plain version on
    the CPU within 5e-2."""
    from repro_torch.configs import get_config
    from repro_torch.core import ContinuousTuner, TrafficLog, best_schedule
    from repro_torch.runtime.serve_loop import decode_ops

    ops = decode_ops(get_config("mobilellm_125m"), batch)
    db, log = TuningDatabase(), TrafficLog()
    for count, wl in ops:
        best_schedule(wl, H100, database=db, traffic=log, count=count)
    runner = CudaRunner(H100)
    result = ContinuousTuner(log, H100, runner=runner, database=db,
                             trials_per_shape=4,
                             max_shapes_per_cycle=len(ops)).tune_once()
    assert len(result.reports) == 5
    for rep in result.reports:
        wl = rep.workload
        assert wl.op == ("gemv" if batch == 1 else "matmul")
        params, provenance = kernel_params(wl, H100, database=db)
        assert provenance == "tuned"
        inputs = runner.inputs(wl)
        got = kernels.build(wl, params)(*inputs)
        want = kernels.build(wl, params, device="cpu")(
            *(t.cpu() for t in inputs))
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=5e-2, atol=5e-2)


def test_f32_logits_on_the_card_match_the_cpu(cuda):
    """MobileLLM-125M at its full widths, four layers, f32 with TF32 off:
    prefill and three decode steps' logits on the card within 1e-3 of the
    same model's on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build

    cfg = dataclasses.replace(get_config("mobilellm_125m"), n_layers=4,
                              dtype="float32")
    on_card, on_cpu = build(cfg), build(cfg, device="cpu")
    params = on_cpu.init(torch.Generator().manual_seed(1))
    params_card = on_card.init(torch.Generator().manual_seed(1))
    params_card.load_state_dict(params.state_dict())
    tokens = on_cpu.make_batch(1, ShapeSpec("p", 67, 2, "decode"),
                               train=False)["tokens"]
    prompt = {"tokens": tokens[:, :64]}
    got, cache = on_card.prefill_fn(params_card, prompt, 80)
    want, cache_cpu = on_cpu.prefill_fn(params, prompt, 80)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    for pos in range(64, 67):
        tok = tokens[:, pos:pos + 1]
        got, cache = on_card.decode_fn(params_card, cache, tok, pos)
        want, cache_cpu = on_cpu.decode_fn(params, cache_cpu, tok, pos)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "moonshot_v1_16b_a3b",
                                  "mamba2_780m", "recurrentgemma_2b",
                                  "whisper_tiny"])
def test_family_logits_on_the_card_match_the_cpu(cuda, arch):
    """The moe, ssm, hybrid and encdec families at reduced(), f32 with
    TF32 off: forward, prefill and three decode steps' logits on the card
    within 1e-3 of the same model's on the CPU (whisper's frames in the
    batch)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build

    cfg = get_config(arch).reduced()
    on_card, on_cpu = build(cfg), build(cfg, device="cpu")
    params = on_cpu.init(torch.Generator().manual_seed(1))
    params_card = on_card.init(torch.Generator().manual_seed(1))
    params_card.load_state_dict(params.state_dict())
    batch = on_cpu.make_batch(1, ShapeSpec("p", 19, 2, "decode"),
                              train=False)
    with torch.no_grad():
        torch.testing.assert_close(on_card.forward(params_card, batch).cpu(),
                                   on_cpu.forward(params, batch), rtol=1e-3,
                                   atol=1e-3)
    prompt = dict(batch, tokens=batch["tokens"][:, :16])
    got, cache = on_card.prefill_fn(params_card, prompt, 24)
    want, cache_cpu = on_cpu.prefill_fn(params, prompt, 24)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    for pos in range(16, 19):
        tok = batch["tokens"][:, pos:pos + 1]
        got, cache = on_card.decode_fn(params_card, cache, tok, pos)
        want, cache_cpu = on_cpu.decode_fn(params, cache_cpu, tok, pos)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
