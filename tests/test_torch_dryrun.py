"""The port's dry run (``repro_torch.launch.dryrun``, ``report``) against
the reference's (``repro.launch.dryrun``, ``report``).

The reference's whole 512-device run does not run under jax 0.9 (its
activation constraints name ``UNCONSTRAINED`` on Explicit mesh axes), so
the port is held against its parts: ``input_specs`` and ``model_flops``
for every cell, the report's tables on one hand-made results dict, and
the reduced Granite train step's per-device flops on a one-device mesh
against ``hlo_analysis`` of the reference's step (Auto axes, as
``tests/test_torch_sharded_train.py`` gives them). The
``test_torch_dryrun_cells_*`` files trace a train, a prefill and a decode
cell of one architecture of each family at ``reduced()`` on the fake 16x16
mesh. Every test leaves no process group behind.
"""

import os

import jax
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

# the XLA backend at optimization level 0 (tests/_torch_jax.py's fast_jit)
FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. Its first lines set XLA_FLAGS for
    512 host devices; JAX's backend is up before it is imported, and the
    variable is restored after, so neither this process nor the ones it
    starts see them."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


def test_input_specs_equal_the_reference(ref_dryrun):
    for arch in ARCH_IDS:
        cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
        for name in cells(arch):
            shape = SHAPES[name]
            got = dryrun.input_specs(cfg, shape, shape.kind)
            want = ref_dryrun.input_specs(ref_cfg, ref_configs.SHAPES[name],
                                          shape.kind)
            assert got.keys() == want.keys(), (arch, name)
            for key, t in got.items():
                assert t.is_meta
                assert (tuple(t.shape), str(t.dtype)) == (
                    tuple(want[key].shape), f"torch.{want[key].dtype}"), \
                    (arch, name, key)


def test_model_flops_equal_the_reference(ref_dryrun):
    for arch in ARCH_IDS:
        for name in cells(arch):
            for kind in ("train", "prefill", "decode"):
                assert dryrun.model_flops(get_config(arch), SHAPES[name],
                                          kind) == \
                    ref_dryrun.model_flops(ref_configs.get_config(arch),
                                           ref_configs.SHAPES[name], kind)


def _record(arch, shape, mesh, t, dominant, peak, counts, ok=True):
    """One results record with what the tables read (``compile_s`` and
    ``trace_s`` alike: the reference's column reads one, the port's the
    other)."""
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                "error": "RuntimeError: " + "x" * 80}
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
            "ok": True, "compile_s": t, "trace_s": t,
            "memory": {"peak_estimate_bytes": peak},
            "analysis": {"collective_counts": counts},
            "roofline": {"t_compute_s": t / 3, "t_memory_s": t * 2e-4,
                         "t_collective_s": t * 3e-7, "dominant": dominant,
                         "useful_flops_ratio": 0.75,
                         "roofline_fraction": t / 100}}


RESULTS = {
    "a/train_4k/16x16": _record("a", "train_4k", "16x16", 12.5, "compute",
                                3 * 2**30, {"all-gather": 4.0}),
    "a/train_4k/2x16x16": _record("a", "train_4k", "2x16x16", 20.0,
                                  "collective", 2**31,
                                  {"all-reduce": 2.0, "all-gather": 1.0}),
    "b/decode_32k/16x16": _record("b", "decode_32k", "16x16", 0.4,
                                  "memory", 5 * 2**29, {}),
    "c/prefill_32k/16x16": _record("c", "prefill_32k", "16x16", 0, "", 0,
                                   {}, ok=False),
}


def test_report_tables_equal_the_reference():
    """Line for line, but for the summary's budget line (the H100's 85.02
    GB, not a TPU's 16 GiB) and the cells table's header, whose time
    column is the trace's, not a compile's."""
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(RESULTS, mesh) == \
            ref_report.roofline_table(RESULTS, mesh)
    got, want = report.dryrun_table(RESULTS), ref_report.dryrun_table(RESULTS)
    assert got[0] == want[0].replace("| compile |", "| trace |")
    assert got[1:] == want[1:]
    got, want = report.summary(RESULTS), ref_report.summary(RESULTS)
    assert len(got) == len(want)
    assert [g for g, w in zip(got, want) if g != w] == [
        "- max per-device memory: 3.00 GiB (the H100's 85.02 GB)"]


def test_one_device_step_flops_against_the_reference(ref_dryrun,
                                                     monkeypatch):
    """The reduced Granite train step (remat full, seq 32, batch 4) on a
    (1, 1) mesh: the port's per-device flops equal ``hlo_analysis``'s of
    the reference's compiled step on one JAX device, exactly. The port's
    chunked attention pads the key slots to a chunk multiple as the
    reference's does (``src/repro/models/layers.py:186-187``), so both
    count the same products, the remat's recomputed forward among them;
    only a dot XLA rewrote would part them."""
    shape = ShapeSpec("train_4k", 32, 4, "train")
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setitem(SHAPES, "train_4k", shape)
    with dryrun.fake_world(1):
        mesh = make_host_mesh("cpu")
        fn, args = dryrun.build_cell("granite_3_2b", "train_4k", mesh)
        rec = dryrun.trace_step(fn, args, mesh, {},
                                get_config("granite_3_2b").reduced(), shape)
    assert rec["analysis"]["collective_bytes"] == 0

    monkeypatch.setattr(ref_dryrun, "get_config",
                        lambda a: ref_configs.get_config(a).reduced())
    monkeypatch.setitem(ref_configs.SHAPES, "train_4k", shape)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
    ref_layers.set_activation_sharding(("data",), 1, "model", 1)
    try:
        with jax.set_mesh(ref_mesh):
            ref_fn, ref_args = ref_dryrun.build_cell("granite_3_2b",
                                                     "train_4k", ref_mesh)
            text = ref_fn.lower(*ref_args).compile(FAST).as_text()
    finally:
        ref_layers.clear_activation_sharding()
    want = hlo_analysis.analyze(text).flops
    assert rec["analysis"]["flops"] == want


def test_one_device_trace_counts_what_the_plain_step_runs():
    """The train launcher's step (reduced Granite, its batch, sequence,
    remat and optimizer) run plainly on the CPU with drawn weights, and
    traced on a fake (1, 1) mesh with a meta state: the same flops, bytes
    and memory, no collective (the CPU form of ``chip_smoke.py`` phase
    11's card-against-trace check)."""
    from repro_torch.launch import op_analysis, train as launch_train
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.train_loop import (init_train_state,
                                                jit_train_step,
                                                make_train_step)

    args = launch_train.parse_args(["--device", "cpu"])
    cfg = get_config(args.arch).reduced()
    opt = launch_train.opt_config(args)
    shape = ShapeSpec("t", args.seq_len, args.batch, "train")
    bundle = build(cfg, remat=args.remat, device="cpu")
    state = init_train_state(bundle, torch.Generator().manual_seed(0), opt)
    batch = {k: torch.as_tensor(v) for k, v in
             bundle.make_batch(0, shape).items()}
    plain = op_analysis.analyze(make_train_step(bundle, opt), state, batch)

    meta = build(cfg, remat=args.remat, device="meta")
    with dryrun.fake_world(1):
        mesh = make_host_mesh("cpu")
        state = init_train_state(meta, None, opt)
        step, _, _ = jit_train_step(make_train_step(meta, opt), state, mesh,
                                    {"tokens": 2})
        rec = dryrun.trace_step(step, (state, dryrun.input_specs(
            cfg, shape, "train")), mesh, {}, cfg, shape)
    assert rec["analysis"]["flops"] == plain.flops > 0
    assert rec["analysis"]["bytes"] == plain.bytes
    assert rec["analysis"]["collective_bytes"] == 0
    assert not rec["analysis"]["collective_counts"]
    assert rec["memory"] == plain.memory
