"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same device tensors, launch refusal on both sides of
each launch gate, the CUDA runner, interleaved sessions and dispatch. They
need a CUDA device and skip without one.

Run on a machine with an H100:  python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (H100, CudaRunner, Schedule, TuningDatabase,  # noqa: E402
                              TuningSession, concretize, kernel_params, tune)
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
from repro_torch.kernels.qmatmul import plain as qmatmul_plain  # noqa: E402
from repro_torch.kernels.qmatmul.kernel import qmatmul_blocked  # noqa: E402
from repro_torch.kernels.vmacc import plain as vmacc_plain  # noqa: E402
from repro_torch.kernels.vmacc.kernel import vmacc_blocked  # noqa: E402

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
    with pytest.raises(KernelLaunchError) as err:   # 4096 threads per block
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
    bf16 = dtype == torch.bfloat16
    if limit == "micro_tile":                    # f32, int8: 4x4 per thread
        return (4, 4, 16), (6, 4, 16)
    if limit.startswith("grain_"):               # bf16: 16x16x16 fragments
        dim = "mnk".index(limit[-1])
        beyond = [16, 16, 16]
        beyond[dim] = 24
        return (16, 16, 16), tuple(beyond)
    if limit == "threads":                       # bm * bn <= 16384
        return (128, 128, 16), ((144, 128, 16) if bf16 else (132, 128, 16))
    if limit == "dp4a":                          # int8 bk % 4
        return (4, 4, 4), (4, 4, 6)
    grain = {torch.int8: 4, torch.bfloat16: 16}.get(dtype, 1)  # smem
    bk = grain
    while matmul_ops.supports_block_shape(16, 16, bk + grain,
                                          _GATE_DTYPE[dtype],
                                          H100.vmem_capacity):
        bk += grain
    return (16, 16, bk), (16, 16, bk + grain)


@pytest.mark.parametrize("limit,dtype", [
    (limit, dtype) for limit in ("micro_tile", "threads", "smem")
    for dtype in (torch.float32, torch.int8)
] + [("dp4a", torch.int8)] + [
    (limit, torch.bfloat16)
    for limit in ("grain_m", "grain_n", "grain_k", "threads", "smem")])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_python_gate_matches_kernel_limits(cuda, limit, dtype, inside):
    """The Python gate and the kernels' own checks (csrc/tile.cuh for f32
    and int8, csrc/matmul.cu's tensor-core launcher for bf16) agree on both
    sides of every limit: a block the gate accepts launches and is right,
    and one step beyond it the card refuses the launch."""
    block = _gate_boundary(limit, dtype)[0 if inside else 1]
    assert matmul_ops.supports_block_shape(
        *block, _GATE_DTYPE[dtype], H100.vmem_capacity) is inside
    x, w = _operands(*block, dtype, cuda)      # one block: (bm, bk) @ (bk, bn)
    pairs = [(lambda acc=acc: matmul_blocked(x, w, block, accumulate=acc),
              lambda: matmul_plain.matmul_plain(x, w, block[2]))
             for acc in (True, False)]
    if dtype == torch.int8:
        bias = torch.zeros(block[1], dtype=torch.int32, device=cuda)
        pairs.append((lambda: qmatmul_blocked(x, w, bias, 0.01, block),
                      lambda: qmatmul_plain.qmatmul_plain(x, w, bias, 0.01,
                                                          block[2])))
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
    """Every bf16 kernel of csrc/matmul.cu (both entries, each warp layout)
    issues HMMA, the tensor cores' instruction, in the built SASS; the f32
    and int8 kernels issue none."""
    functions = _build.sass("matmul")
    tc = [name for name in functions if "matmul_tc_kernel" in name]
    assert len(tc) == 10, sorted(functions)   # 5 warp layouts x 2 entries
    for name, body in functions.items():
        assert ("HMMA" in body) == (name in tc), name


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
    ((2048, 64), (1024, 16)),      # one thread per column
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
    """One thread per output column at most 1024 threads: the gate and the
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
    H100's limit: the largest head dim the gate accepts for a (128, 128)
    block launches and is right, one more is refused by the card."""
    pd = 1
    while fa_ops.supports_block_shape(128, 128, pd + 1, dtype,
                                      H100.vmem_capacity):
        pd += 1
    if not inside:
        pd += 1
    assert fa_ops.supports_block_shape(128, 128, pd, dtype,
                                       H100.vmem_capacity) is inside
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
