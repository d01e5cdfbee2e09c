"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same device tensors, launch refusal, the CUDA
runner and dispatch. They need a CUDA device and skip without one.

Run on a machine with an H100:  python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (H100, CudaRunner, Schedule, TuningDatabase,  # noqa: E402
                              concretize, kernel_params, tune)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.kernels._build import KernelLaunchError  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.kernels.matmul import plain as matmul_plain  # noqa: E402
from repro_torch.kernels.matmul.kernel import matmul_blocked  # noqa: E402
from repro_torch.kernels.qmatmul import plain as qmatmul_plain  # noqa: E402
from repro_torch.kernels.qmatmul.kernel import qmatmul_blocked  # noqa: E402

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
    if limit == "micro_tile":
        return (4, 4, 16), (6, 4, 16)
    if limit == "threads":                       # (bm/4) * (bn/4) <= 1024
        return (128, 128, 16), (132, 128, 16)
    if limit == "dp4a":                          # int8 bk % 4
        return (4, 4, 4), (4, 4, 6)
    grain = 4 if dtype == torch.int8 else 1      # shared memory
    bk = grain
    while matmul_ops.supports_block_shape(16, 16, bk + grain,
                                          _GATE_DTYPE[dtype],
                                          H100.vmem_capacity):
        bk += grain
    return (16, 16, bk), (16, 16, bk + grain)


@pytest.mark.parametrize("limit,dtype", [
    (limit, dtype) for limit in ("micro_tile", "threads", "smem")
    for dtype in (torch.float32, torch.bfloat16, torch.int8)
] + [("dp4a", torch.int8)])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond"])
def test_python_gate_matches_kernel_limits(cuda, limit, dtype, inside):
    """The Python gate and the kernels' own checks (csrc/tile.cuh) agree on
    both sides of every limit: a block the gate accepts launches and is
    right, and one step beyond it the card refuses the launch."""
    block = _gate_boundary(limit, dtype)[0 if inside else 1]
    assert matmul_ops.supports_block_shape(
        *block, _GATE_DTYPE[dtype], H100.vmem_capacity) is inside
    x, w = _operands(*block, dtype, cuda)      # one block: (bm, bk) @ (bk, bn)
    pairs = [(lambda: matmul_blocked(x, w, block),
              lambda: matmul_plain.matmul_plain(x, w, block[2]))]
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
