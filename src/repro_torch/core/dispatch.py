"""Framework-wide schedule dispatch — the technique as a first-class feature.

Every tensor op resolves its kernel schedule through a four-rung chain
(mirroring how a TVM deployment uses its tuning log):

  1. tuned    — best record in the tuning database for the exact
                (workload, hardware) key;
  2. bucketed — the nearest tuned *bucket*: the best record of the closest
                same-op shape on the same hardware whose schedule
                concretizes valid on the actual shape
                (:meth:`TuningDatabase.nearest_tuned`);
  3. fixed    — the hand-written library default (the muRISCV-NN analogue);
  4. None     — fall back to the library baseline (``kernels.baseline``,
                the JAX package's XLA rung; provenance stays ``"xla"`` so
                records and reports read alike in both packages).

The hardware defaults to :data:`~repro_torch.core.hardware.H100`.
:func:`ensure_tuned` pre-tunes a whole model config (a network of
:mod:`repro_torch.nets`, or ``runtime.serve_loop.decode_ops``) through a
:class:`~repro_torch.core.session.TuningSession`, so that every op resolves
``"tuned"``.

Dispatch is also the sensor of the serving↔tuning loop
(``core/traffic.py``): every resolution that does *not* hit rung 1 is a
cache miss or near miss, and its workload shape is recorded into a
:class:`~repro_torch.core.traffic.TrafficLog` (the explicit ``traffic=``
argument, else the process-wide log installed via
:func:`~repro_torch.core.traffic.set_traffic_log`). A
:class:`~repro_torch.core.traffic.ContinuousTuner` drains that log and
ships new records into the database, which ``global_database()`` hot-swaps
into running servers by mtime. With no log installed (the default)
recording is off and dispatch has zero tuning-side effects.

Every rung is memoized per ``(workload.key(), hw.name)``: tuned and
bucketed lookups through the caches on :class:`TuningDatabase` (invalidated
by ``add``/``load``), fixed-library schedules through a module-level cache
here that :func:`invalidate_dispatch_caches` — called by
``reset_global_database`` — drops. Below the chain, :func:`kernel_params`
concretizes through the memoized ``space.concretize`` and any
``kernels.build`` of the result is served from the content-addressed
:class:`~repro_torch.core.build_cache.BuildCache`.
"""

from __future__ import annotations

from repro_torch import tracing
from repro_torch.core import space as space_lib
from repro_torch.core import traffic as traffic_lib
from repro_torch.core.database import TuningDatabase, global_database
from repro_torch.core.hardware import H100, HardwareConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload


# (workload key, hardware name) -> Schedule; bounded by the distinct
# workloads a process serves. Schedules are immutable, sharing is safe.
_FIXED_CACHE: dict[tuple[str, str], Schedule] = {}


def fixed_library_schedule(workload: Workload, hw: HardwareConfig) -> Schedule:
    """The hand-crafted default: one fixed choice per op family, written once
    for the baseline hardware and *not* re-derived per config (exactly the
    property of muRISCV-NN the paper exploits: its kernels assume one VLEN).
    Memoized per (workload, hardware) — see module docstring.

    These stay v1 flat-layout traces (``*_scale`` decisions) on purpose:
    they are what a hand-written library looks like — no generative
    structure — and they exercise the legacy concretize path every
    deployment relies on. When one seeds a generative search it is adopted
    onto the workload's :class:`~repro_torch.core.space.SpaceProgram` via replay.
    """
    cache_key = (workload.key(), hw.name)
    cached = _FIXED_CACHE.get(cache_key)
    if cached is not None:
        return cached
    schedule = _FIXED_CACHE[cache_key] = _fixed_library_schedule(workload, hw)
    return schedule


def _fixed_library_schedule(workload: Workload,
                            hw: HardwareConfig) -> Schedule:
    from repro_torch.core import intrinsics  # local to avoid cycles

    variants = intrinsics.variants_for(workload, hw)
    # Hand-written kernel libraries (muRISCV-NN / CMSIS-NN style):
    #  - one hard-coded mid-ladder granularity, written for the baseline
    #    config, never re-derived per shape or hardware (Fig. 4 mechanism);
    #  - narrow row-kernels (a few output rows x vector width), so output
    #    tiles are small (m_scale 0.25);
    #  - the int8 requant pipeline stores int32 intermediates to memory
    #    before rescaling (accumulate=False on the quantized path) — the
    #    store traffic the paper's Fig. 5 trace analysis measures;
    #  - float paths: the paper notes muRISCV-NN has none; this float
    #    default stands for "our hand-written kernel, frozen" and does
    #    accumulate in-core.
    names = [v.name for v in variants]
    # The H100's attention ladder stops at fa_128x128, so attention falls
    # to names[0], fa_128x128 (clamped to the sequence by concretize); the
    # TPU configs pick fa_256x256 where the sequence admits it.
    pick = None
    for preferred in ("mxu_256", "vl_2048", "vl_32x1024", "fa_256x256"):
        if preferred in names:
            pick = preferred
            break
    if pick is None:
        pick = names[0]
    choices = {"variant": pick}
    if workload.op == "qmatmul":
        choices.update(m_scale=0.25, n_scale=1.0, k_scale=1.0, order="mnk",
                       accumulate=False)
    elif workload.op == "matmul":
        choices.update(m_scale=0.25, n_scale=1.0, k_scale=1.0, order="mnk",
                       accumulate=True)
    elif workload.op == "gemv":
        choices.update(k_scale=1.0, accumulate=True)
    elif workload.op == "vmacc":
        choices.update(r_scale=1.0)
    return Schedule.fixed(**choices)


def invalidate_dispatch_caches() -> None:
    """Drop the module-level fixed-library schedule cache. The tuned and
    bucketed rungs are cached on the :class:`TuningDatabase` instance and
    invalidated by its own ``add``/``load``; this drops the one cache that
    outlives database instances, so after ``reset_global_database()`` no
    stale schedule stays reachable through the old chain."""
    _FIXED_CACHE.clear()


def _record_miss(traffic, workload: Workload, hw: HardwareConfig,
                 provenance: str, count: int) -> None:
    log = traffic if traffic is not None else traffic_lib.installed_log()
    if log is not None:
        log.record(workload, hw.name, provenance, count=count)


def best_schedule(workload: Workload, hw: HardwareConfig = H100,
                  database: TuningDatabase | None = None,
                  allow_fixed: bool = True, allow_bucketed: bool = True,
                  traffic=None, count: int = 1) -> tuple[Schedule | None,
                                                         str]:
    """Resolve (schedule, provenance) for an op instance.

    ``provenance`` is one of ``"tuned"`` / ``"bucketed"`` / ``"fixed"`` /
    ``"xla"`` — the rung that resolved (module docstring). Every
    non-``"tuned"`` resolution is recorded as a miss into ``traffic`` (or
    the process-wide installed log; neither present = recording off);
    ``count`` is the op's multiplicity in the caller's step (e.g. layer
    count), so the traffic log's hit counters reflect real demand."""
    db = database if database is not None else global_database()
    rec = db.best(workload, hw.name)
    if rec is not None:
        return rec[0], "tuned"
    if allow_bucketed:
        bucket = db.nearest_tuned(workload, hw)
        if bucket is not None:
            # a near miss: served from the neighbouring bucket, but still
            # worth tuning exactly — record it so the tuner closes the gap
            _record_miss(traffic, workload, hw, "bucketed", count)
            return bucket[0], "bucketed"
    if allow_fixed:
        _record_miss(traffic, workload, hw, "fixed", count)
        return fixed_library_schedule(workload, hw), "fixed"
    _record_miss(traffic, workload, hw, "xla", count)
    return None, "xla"


def kernel_params(workload: Workload, hw: HardwareConfig = H100,
                  database: TuningDatabase | None = None,
                  allow_fixed: bool = True, allow_bucketed: bool = True,
                  traffic=None, count: int = 1):
    with tracing.span("dispatch.kernel_params"):
        sched, provenance = best_schedule(workload, hw, database,
                                          allow_fixed=allow_fixed,
                                          allow_bucketed=allow_bucketed,
                                          traffic=traffic, count=count)
        if sched is None:
            return None, provenance
        return space_lib.concretize(workload, hw, sched), provenance


def ensure_tuned(ops, hw: HardwareConfig = H100,
                 runner=None, database: TuningDatabase | None = None,
                 trials_per_workload: int = 32, seed: int = 0,
                 log=None, model: str = ""):
    """Fill the dispatch database for a whole model config.

    Runs a :class:`~repro_torch.core.session.TuningSession` over the
    workloads of ``ops`` (``[(count, Workload), ...]``) that have **no**
    tuned record yet, so every subsequent :func:`best_schedule` call for
    them resolves to ``"tuned"``. Already-covered workloads are not
    re-tuned — calling this before serving a model is idempotent and cheap
    on a warm database.

    The default runner measures where the config says the kernels run:
    ``CudaRunner(hw)`` on the card for a :class:`CudaHardwareConfig`
    (raising without one; no CPU fallback), the analytic model for a TPU
    config, as in the JAX package.

    Returns the :class:`SessionResult`, or ``None`` if the database already
    covers every workload.
    """
    from repro_torch.core.runner import default_runner
    from repro_torch.core.session import TuningSession, dedup_workloads

    db = database if database is not None else global_database()
    missing = [(count, wl) for count, wl in dedup_workloads(ops)
               if db.best(wl, hw.name) is None]
    if not missing:
        return None
    if runner is None:
        runner = default_runner(hw)
    session = TuningSession(hw, runner, database=db, log=log)
    return session.tune_model(missing,
                              total_trials=trials_per_workload * len(missing),
                              seed=seed, model=model)
