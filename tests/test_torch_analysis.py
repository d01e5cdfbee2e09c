"""The port's per-device op analysis (``repro_torch.launch.op_analysis``)
against the reference's HLO analyzer (``repro.launch.hlo_analysis``).

The five analyzer cases of ``tests/test_sharding_and_analysis.py`` with
their assertions, each count also held against ``hlo_analysis.analyze`` of
the jitted JAX function on the same inputs. The reference's assertion that
XLA's ``cost_analysis`` undercounts a scan (``xla < 0.2 * expect``) has no
counterpart: eager PyTorch runs a Python loop's every iteration, and there
is no XLA cost analysis to undercount it.

Then per device on a fake 16x16 ("data", "model") process group (no data
moves), each against its closed form: a matmul laid out x ``[Shard(0),
Shard(1)]``, w ``[Replicate(), Shard(0)]`` (its contraction sharded over
"model": a pending sum, no collective), the same with the sum carried out
(an all-reduce, counted at two times its output bytes), and an FSDP x TP
weight that DTensor gathers over "data" before its matmul.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402

from repro_torch.launch import dryrun, op_analysis  # noqa: E402


def _hlo(fn, *args):
    """The reference analyzer's summary of ``jax.jit(fn)`` on ``args``."""
    return hlo_analysis.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_analyzer_counts_single_matmul():
    x, w = _inputs((256, 512), (512, 128))
    s = op_analysis.analyze(lambda a, b: a @ b, torch.tensor(x),
                            torch.tensor(w))
    assert s.flops == pytest.approx(2 * 256 * 512 * 128, rel=0.01)
    assert s.flops == _hlo(lambda a, b: a @ b, x, w).flops


def test_analyzer_counts_every_loop_iteration():
    """The reference's scan over 12 weights is a Python loop here: eager
    code runs (and the mode counts) each of its 12 matmuls."""
    def looped(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x

    def scanned(x, ws):
        def body(c, w):
            return c @ w, None
        out, _ = jax.lax.scan(body, x, ws)
        return out

    x, ws = _inputs((128, 128), (12, 128, 128))
    s = op_analysis.analyze(looped, torch.tensor(x), torch.tensor(ws))
    expect = 12 * 2 * 128**3
    assert s.flops == pytest.approx(expect, rel=0.01)
    assert s.flops == _hlo(scanned, x, ws).flops


def test_analyzer_nested_loops():
    def nested(x, ws):
        for w in ws.unbind(0):
            for _ in range(3):
                x = x @ w
        return x

    def nested_scans(x, ws):
        def outer(c, w):
            def inner(ci, _):
                return ci @ w, None
            ci, _ = jax.lax.scan(inner, c, None, length=3)
            return ci, None
        out, _ = jax.lax.scan(outer, x, ws)
        return out

    x, ws = _inputs((64, 64), (5, 64, 64))
    s = op_analysis.analyze(nested, torch.tensor(x), torch.tensor(ws))
    assert s.flops == pytest.approx(5 * 3 * 2 * 64**3, rel=0.02)
    assert s.flops == _hlo(nested_scans, x, ws).flops


def test_analyzer_shape_bytes():
    """The reference's four values, on tensors in place of type strings."""
    cases = [(torch.empty(16, 128, dtype=torch.bfloat16), "bf16[16,128]{1,0}"),
             ((torch.empty(4, 4), torch.empty(8, dtype=torch.int8)),
              "(f32[4,4], s8[8])"),
             (torch.empty(()), "f32[]")]
    assert [op_analysis.shape_bytes(t) for t, _ in cases] == \
        [16 * 128 * 2, 64 + 8, 4]
    for t, text in cases:
        assert op_analysis.shape_bytes(t) == hlo_analysis.shape_bytes(text)
    assert op_analysis.shape_dims(torch.empty(3, 5, 7)) == [3, 5, 7] == \
        hlo_analysis.shape_dims("f32[3,5,7]{2,1,0}")


def test_analyzer_census_categories():
    a, = _inputs((64, 64))
    s = op_analysis.analyze(lambda a: torch.tanh(a) @ a, torch.tensor(a))
    assert s.op_census.get("compute", 0) >= 1
    assert s.n_instructions > 0
    ref = _hlo(lambda a: jnp.tanh(a) @ a, a)
    assert ref.op_census.get("compute", 0) >= 1
    assert s.flops == ref.flops == 2 * 64**3


@pytest.fixture
def fake_mesh():
    """The production 16x16 mesh on a fake 256-rank group, destroyed
    after the test (xdist runs other files in this process)."""
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_world(256):
        yield make_production_mesh(device="cpu")
    assert not dist.is_initialized()


def _placed(mesh, shape, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements, src_data_rank=None)


def test_per_device_matmul_with_a_sharded_contraction(fake_mesh):
    """x (256, 512) [Shard(0), Shard(1)] @ w (512, 128) [Replicate(),
    Shard(0)]: each device multiplies its (16, 32) by its (32, 128) into a
    pending sum over "model"; no data moves. A FlopCounterMode counts the
    DTensor op at its global 2 * 256 * 512 * 128."""
    from torch.distributed.tensor import Replicate, Shard

    x = _placed(fake_mesh, (256, 512), [Shard(0), Shard(1)])
    w = _placed(fake_mesh, (512, 128), [Replicate(), Shard(0)])
    s = op_analysis.analyze(lambda a, b: a @ b, x, w)
    assert s.flops == 2 * 16 * 32 * 128
    assert s.bytes == 4 * (16 * 32 + 32 * 128 + 16 * 128)
    assert s.collective_bytes == 0 and not s.collective_counts


def test_per_device_all_reduce_counts_its_output_twice(fake_mesh):
    """The same product with its sum over "model" carried out: one
    all-reduce of the (16, 128) f32 partial, 2 * 8192 bytes."""
    from torch.distributed.tensor import Replicate, Shard

    x = _placed(fake_mesh, (256, 512), [Shard(0), Shard(1)])
    w = _placed(fake_mesh, (512, 128), [Replicate(), Shard(0)])
    s = op_analysis.analyze(
        lambda a, b: (a @ b).redistribute(fake_mesh, [Shard(0), Replicate()]),
        x, w)
    assert s.flops == 2 * 16 * 32 * 128
    assert dict(s.collective_counts) == {"all-reduce": 1}
    assert s.collective_bytes == dict(s.collective_bytes_by_op)[
        "all-reduce"] == 2 * 16 * 128 * 4


def test_per_device_fsdp_weight_is_gathered(fake_mesh):
    """x (256, 512) [Shard(0), Replicate()] @ w (512, 128) [Shard(0),
    Shard(1)] (FSDP over "data", TP over "model"): DTensor all-gathers w's
    (32, 8) shards over "data" into (512, 8), then each device multiplies
    its (16, 512) rows by it."""
    from torch.distributed.tensor import Replicate, Shard

    x = _placed(fake_mesh, (256, 512), [Shard(0), Replicate()])
    w = _placed(fake_mesh, (512, 128), [Shard(0), Shard(1)])
    s = op_analysis.analyze(lambda a, b: a @ b, x, w)
    assert s.flops == 2 * 16 * 512 * 8
    assert dict(s.collective_counts) == {"all-gather": 1}
    assert s.collective_bytes == 512 * 8 * 4
