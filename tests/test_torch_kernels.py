"""The port's kernels (their plain CPU versions) against the JAX package's
Pallas kernels in interpret mode, on the same inputs and KernelParams.

Tolerances are those of tests/test_kernels.py: f32 rtol 1e-4 / atol 1e-3
(the two sum each k block in another order), bf16 5e-2 / 5e-1, int8 and
qmatmul exact. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference package runs on JAX)
from repro import kernels as ref_kernels  # noqa: E402
from repro.core import space as ref_space  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (CPU_EMULATE, INTERPRET, Schedule,  # noqa: E402
                              concretize)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.build_cache import BuildCache  # noqa: E402
from repro_torch.kernels.matmul import plain as matmul_plain  # noqa: E402
from repro_torch.kernels.matmul.kernel import matmul_blocked  # noqa: E402
from repro_torch.kernels.qmatmul.kernel import qmatmul_blocked  # noqa: E402

TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-1)}


def _jax_params(params):
    """The same KernelParams as the reference's dataclass."""
    return ref_space.KernelParams(**dataclasses.asdict(params))


def _both(wl, hw, **decisions):
    params = concretize(wl, hw, Schedule.fixed(**decisions))
    assert params.valid, params.why_invalid
    inputs = wl.example_inputs(1)
    want = np.asarray(ref_kernels.build(wl, _jax_params(params),
                                        interpret=True, cache=False)(*inputs))
    got = kernels.build(wl, params, device="cpu", cache=False)(*inputs)
    return got, want


MATMUL_CASES = [
    # (dims, dtype, decisions on INTERPRET: variant, bm, bn, bk, order, acc)
    ((64, 96, 160), "float32", ("mxu_64", 32, 48, 40, "mnk", True)),
    ((64, 96, 160), "float32", ("mxu_64", 16, 32, 32, "nmk", True)),
    ((64, 96, 160), "float32", ("mxu_64", 32, 32, 32, "mnk", False)),
    ((100, 60, 36), "float32", ("mxu_64", 64, 32, 16, "nmk", False)),
    ((100, 60, 36), "bfloat16", ("mxu_64", 32, 16, 16, "mnk", True)),
    ((48, 40, 64), "int8", ("mxu_32", 16, 8, 16, "mnk", False)),
]


@pytest.mark.parametrize("dims,dtype,dec", MATMUL_CASES)
def test_matmul_matches_pallas_interpret(dims, dtype, dec):
    variant, bm, bn, bk, order, acc = dec
    wl = W.matmul(*dims, dtype)
    got, want = _both(wl, INTERPRET, variant=variant, bm=bm, bn=bn, bk=bk,
                      order=order, accumulate=acc)
    assert tuple(got.shape) == want.shape
    if dtype == "int8":  # int32 product, cast to the int8 out dtype
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dims,dec", [
    ((33, 65, 17), ("mxu_32", 12, 24, 24, "mnk", True)),
    ((64, 48, 100), ("mxu_64", 16, 16, 40, "nmk", False)),
    ((16, 16, 32), ("mxu_16", 16, 16, 16, "mnk", True)),
])
def test_qmatmul_matches_pallas_interpret_exactly(dims, dec):
    variant, bm, bn, bk, order, acc = dec
    wl = W.qmatmul(*dims)
    got, want = _both(wl, INTERPRET, variant=variant, bm=bm, bn=bn, bk=bk,
                      order=order, accumulate=acc)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wl,block", [
    (W.matmul(40, 72, 100, "float32"), (16, 32, 32)),    # padded
    (W.matmul(64, 64, 96, "bfloat16"), (32, 16, 48)),
    (W.qmatmul(33, 65, 17), (16, 32, 32)),                # padded
])
def test_h100_grain_schedules_match_reference_oracle(wl, block):
    """Blocks on the card's grain (CPU_EMULATE) through the port's plain
    path, against the JAX package's jnp oracle."""
    for acc in (True, False):
        params = concretize(wl, CPU_EMULATE, Schedule.fixed(
            variant="mxu_min", bm=block[0], bn=block[1], bk=block[2],
            order="mnk", accumulate=acc))
        assert params.valid, params.why_invalid
        inputs = wl.example_inputs(2)
        got = kernels.build(wl, params, device="cpu")(*inputs)
        want = np.asarray(ref_kernels.reference(wl)(*inputs))
        if wl.op == "qmatmul":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            rtol, atol = TOL[wl.dtype]
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("wl", [W.matmul(24, 40, 56), W.qmatmul(24, 40, 56),
                                W.matmul(24, 40, 56, "int8")])
def test_oracles_and_baselines_match_reference(wl):
    inputs = wl.example_inputs(3)
    tensors = [torch.from_numpy(a) for a in inputs]
    want = np.asarray(ref_kernels.reference(wl)(*inputs))
    np.testing.assert_allclose(
        kernels.reference(wl)(*tensors).numpy().astype(np.float64),
        want.astype(np.float64), rtol=1e-5, atol=1e-5)
    base = kernels.baseline(wl)(*tensors)
    np.testing.assert_allclose(base.float().numpy(), want.astype(np.float32),
                               rtol=1e-4, atol=1e-3)


def test_plain_sums_block_by_block_in_k_order():
    """The plain version adds each k block's product to the running sum,
    as the Pallas grid does (f32, not a single full-k product)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    want = torch.zeros(8, 8)
    for k0 in range(0, 64, 16):
        want += x[:, k0:k0 + 16] @ w[k0:k0 + 16]
    assert torch.equal(matmul_plain.matmul_plain(x, w, 16), want)


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    kernels.reset_launch_counts()
    x = torch.ones(16, 32)
    w = torch.ones(32, 16)
    out = matmul_blocked(x, w, (16, 16, 16), accumulate=False)
    assert torch.equal(out, torch.full((16, 16), 32.0))
    qx = torch.ones(16, 32, dtype=torch.int8)
    qw = torch.ones(32, 32, dtype=torch.int8)
    bias = torch.zeros(32, dtype=torch.int32)
    assert torch.equal(qmatmul_blocked(qx, qw, bias, 0.01, (16, 32, 32)),
                       torch.zeros(16, 32, dtype=torch.int8))
    # no kernel ran: the counts are for CUDA launches only
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        matmul_blocked(x.to("meta"), w.to("meta"), (16, 16, 16))
    with pytest.raises(ValueError):
        matmul_blocked(x, w, (16, 16, 24))          # does not tile k
    with pytest.raises(ValueError):
        matmul_blocked(x, w.t(), (16, 16, 16))      # not contiguous
    with pytest.raises(ValueError):
        qmatmul_blocked(qx, qw, bias[:16], 0.01, (16, 32, 32))


def test_build_cache_keys_on_signature_and_backend():
    wl = W.matmul(32, 32, 32)
    params = concretize(wl, CPU_EMULATE, Schedule.fixed(
        variant="mxu_32", bm=32, bn=32, bk=32, order="mnk", accumulate=True))
    cache = BuildCache()
    cpu = kernels.build(wl, params, device="cpu", cache=cache)
    assert kernels.build(wl, params, device="cpu", cache=cache) is cpu
    # building for the card compiles nothing yet (that happens at launch)
    assert kernels.build(wl, params, device="cuda", cache=cache) is not cpu
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 1
    with pytest.raises(ValueError):
        kernels.build(wl, params, device="tpu", cache=cache)
    with pytest.raises(NotImplementedError):   # attention is not ported
        kernels.build(W.attention(1, 2, 2, 8, 8, 8),
                      dataclasses.replace(params, op="attention"),
                      device="cpu", cache=False)
