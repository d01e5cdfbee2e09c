"""The port's serving loop on the CPU: ``Server`` and its launcher.

- The JAX package's ``test_server_generates_consistent_with_forward`` with
  its assertions (exact ``n_steps``, greedy decode against the argmax of
  the full forward).
- The port's ``Server`` emits the JAX ``Server``'s tokens on the
  reference's weights carried across, for a config of every family
  (whisper's stub frames through ``extra_batch``).
- ``decode_ops`` equals the reference's for all twelve configs, the
  zero-width rows of attention-free Mamba2 pinned, and both packages'
  dispatch resolves those rows to "fixed".
- ``build_kernels=True``: the first dispatch pass builds through the
  process-wide build cache, the steady state builds nothing, a schedule
  that does not concretize valid is skipped, and a failing build raises
  instead of being swallowed.

The launcher (``python -m repro_torch.launch.serve``) is held in
``tests/test_torch_serve_launcher.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import TrafficLog as RefTrafficLog  # noqa: E402
from repro.core import TuningDatabase as RefDatabase  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core.dispatch import best_schedule as ref_best  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402
from repro.runtime.serve_loop import Server as RefServer  # noqa: E402
from repro.runtime.serve_loop import decode_ops as ref_decode_ops  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import (CPU_EMULATE, H100, V5E,  # noqa: E402
                              ContinuousTuner, EmulateRunner, TrafficLog,
                              TuningDatabase, build_cache_stats,
                              clear_build_cache)
from repro_torch.core.dispatch import best_schedule  # noqa: E402
from repro_torch.core import space as space_lib  # noqa: E402
from repro_torch.models.model_zoo import (build,  # noqa: E402
                                          from_numpy_params)
from repro_torch.runtime.serve_loop import Server, decode_ops  # noqa: E402


def _yi():
    cfg = get_config("yi_6b").reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(2))
    prompts = np.asarray(
        bundle.make_batch(0, ShapeSpec("p", 8, 2, "decode"),
                          train=False)["tokens"])
    return cfg, bundle, params, prompts


def test_server_generates_consistent_with_forward():
    _, bundle, params, prompts = _yi()
    server = Server(bundle, params, max_len=32)

    # n_steps must be exact: generate(0) emits nothing
    out0 = server.generate(prompts, n_steps=0)
    assert out0.tokens.shape == prompts.shape and out0.steps == 0
    np.testing.assert_array_equal(out0.tokens, prompts)
    out1 = server.generate(prompts, n_steps=1)
    assert out1.tokens.shape == (2, 9) and out1.steps == 1

    out = server.generate(prompts, n_steps=6)
    assert out.tokens.shape == (2, 14)
    # greedy decode must match greedy over the full forward logits
    with torch.no_grad():
        full = bundle.forward(params, {"tokens": out.tokens[:, :-1]})
    greedy = torch.argmax(full[:, 7:], dim=-1).numpy()
    np.testing.assert_array_equal(out.tokens[:, 8:], greedy)
    assert out.dispatch is None


@pytest.mark.parametrize("arch", ["yi_6b", "h2o_danube_1_8b",
                                  "qwen2_moe_a2_7b", "mamba2_780m",
                                  "recurrentgemma_2b", "whisper_tiny"])
def test_server_tokens_equal_the_reference_server_s(arch):
    """The same weights, prompts and steps: the same tokens (danube's and
    recurrentgemma's sliding window of 16 is passed during the 12 decode
    steps; whisper's frames ride in ``extra_batch``)."""
    ref_cfg = ref_get_config(arch).reduced()
    rb = ref_build(ref_cfg, remat="none")
    rp = rb.init(jax.random.key(5))
    cfg = get_config(arch).reduced()
    bundle = build(cfg, remat="none", device="cpu")
    params = from_numpy_params(cfg, jax.tree.map(np.asarray, rp), "cpu")
    batch = rb.make_batch(1, ShapeSpec("p", 10, 3, "decode"), train=False)
    prompts = np.asarray(batch.pop("tokens"))
    extra = {k: np.asarray(v) for k, v in batch.items()} or None
    assert (extra is not None) == (cfg.family == "encdec")
    theirs = RefServer(rb, rp, max_len=24).generate(prompts, n_steps=13,
                                                    extra_batch=extra)
    ours = Server(bundle, params, max_len=24).generate(prompts, n_steps=13,
                                                       extra_batch=extra)
    assert ours.tokens.dtype == theirs.tokens.dtype
    np.testing.assert_array_equal(ours.tokens, theirs.tokens)


@pytest.mark.parametrize("arch", ARCH_IDS + EXTRA_IDS)
def test_decode_ops_equal_the_reference_s(arch):
    """Every config, published widths, batch 1 (gemv) and 4 (matmul): the
    reference's workloads, counts and order."""
    for batch in (1, 4):
        ours = decode_ops(get_config(arch), batch)
        theirs = ref_decode_ops(ref_get_config(arch), batch)
        assert [(c, wl.key()) for c, wl in ours] == \
            [(c, wl.key()) for c, wl in theirs]


def test_mamba2_zero_width_rows_resolve_fixed_in_both_packages():
    """Attention-free Mamba2 has q_dim and d_ff 0, so decode_ops gives
    zero-width gemvs. Kept for parity: both packages resolve them (and the
    rest of the step) to "fixed" and log them as misses, which is why the
    card serves Mamba2 without a dispatch layer."""
    ops = decode_ops(get_config("mamba2_780m"), 1)
    assert [(c, wl.op, wl.dims) for c, wl in ops] == [
        (48, "gemv", (0, 1536)), (48, "gemv", (1536, 0)),
        (96, "gemv", (0, 1536)), (48, "gemv", (1536, 0)),
        (1, "gemv", (50304, 1536))]
    log, ref_log = TrafficLog(), RefTrafficLog()
    for (count, wl), (_, ref_wl) in zip(
            ops, ref_decode_ops(ref_get_config("mamba2_780m"), 1)):
        for hw, traffic in ((H100, None), (V5E, log)):
            sched, provenance = best_schedule(wl, hw,
                                              database=TuningDatabase(),
                                              traffic=traffic, count=count)
            assert provenance == "fixed" and sched is not None
        ref_sched, ref_provenance = ref_best(ref_wl, ref_hw.V5E,
                                             database=RefDatabase(),
                                             traffic=ref_log, count=count)
        assert ref_provenance == "fixed"
        assert sched.to_json() == ref_sched.to_json()
    assert [(e.workload.key(), e.hits) for e in log.hottest()] == \
        [(e.workload.key(), e.hits) for e in ref_log.hottest()]


def test_build_kernels_steady_state_builds_nothing():
    cfg, bundle, params, prompts = _yi()
    ops = decode_ops(cfg, batch=2)
    server = Server(bundle, params, max_len=16, hw=CPU_EMULATE,
                    serve_ops=ops, database=TuningDatabase(),
                    build_kernels=True)
    clear_build_cache()
    res = server.generate(prompts, n_steps=2)
    assert res.dispatch == {"fixed": sum(c for c, _ in ops)}
    first = build_cache_stats()
    # one build per distinct lowering (QKV and up share a shape here)
    assert first["misses"] == len({wl.key() for _, wl in ops}) == 4
    server.generate(prompts, n_steps=2)
    after = build_cache_stats()
    assert after["misses"] == first["misses"]  # steady state: no builds
    assert after["hits"] - first["hits"] == len(ops)


def test_build_failure_raises_and_invalid_schedule_is_skipped(monkeypatch):
    cfg, bundle, params, prompts = _yi()
    ops = decode_ops(cfg, batch=2)
    server = Server(bundle, params, max_len=16, hw=CPU_EMULATE,
                    serve_ops=ops, database=TuningDatabase(),
                    build_kernels=True)

    def failing_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(kernels, "build", failing_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        server.generate(prompts, n_steps=2)

    class Invalid:
        valid = False

    # a schedule that does not concretize on the shape: skipped, as in the
    # JAX package, and the pass keeps serving
    monkeypatch.setattr(space_lib, "concretize", lambda *a, **k: Invalid())
    res = server.generate(prompts, n_steps=2)
    assert res.dispatch == {"fixed": sum(c for c, _ in ops)}


def test_server_flips_to_tuned_on_emulate_runner():
    """The serving loop on the H100's design space, measured on the host:
    cold "fixed", one ContinuousTuner cycle, then every op "tuned"."""
    cfg, bundle, params, prompts = _yi()
    ops = decode_ops(cfg, batch=1)
    db, log = TuningDatabase(), TrafficLog()
    server = Server(bundle, params, max_len=16, hw=CPU_EMULATE,
                    serve_ops=ops, traffic=log, database=db)
    total = sum(c for c, _ in ops)
    assert server.generate(prompts[:1], n_steps=2).dispatch == \
        {"fixed": total}
    demand: dict[str, int] = {}
    for count, wl in ops:
        demand[wl.key()] = demand.get(wl.key(), 0) + count
    assert {e.workload.key(): e.hits for e in log.hottest()} == demand
    ContinuousTuner(log, CPU_EMULATE, runner=EmulateRunner(CPU_EMULATE),
                    database=db, trials_per_shape=2,
                    max_shapes_per_cycle=len(ops)).tune_once()
    assert server.generate(prompts[:1], n_steps=2).dispatch == \
        {"tuned": total}
