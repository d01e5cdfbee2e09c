"""Static feasibility analysis of design-space programs.

The dynamic validation pipeline (``space.apply_postprocessors``) rejects
illegal traces one candidate at a time, *inside* the propose loop — every
rejection is a sampling attempt wasted, and on a real board farm a
statically-doomed candidate that slips through to measurement burns the
scarcest resource there is. This module turns those runtime rejections into
facts established **once per (workload, hardware), before any sampling**,
by abstract-interpreting the :class:`~repro_torch.core.space.SpaceProgram`:

- **categorical decisions** (the intrinsic variant, loop order, accumulate)
  are enumerated exactly;
- **tile-split decisions** are tracked through the divisor/interval domain
  their candidate generators span: ``tile_candidates`` emits the
  align-multiple divisors of the padded extent capped at the variant's base
  block, so each split's abstract value is a finite divisor set with known
  bounds, and the VMEM footprint — monotone in every block dimension — has
  a provable per-variant floor at the domain's minimum. A variant whose
  floor already exceeds ``HardwareConfig.vmem_budget`` is infeasible in
  *every* completion, no enumeration required.

The result is a :class:`SpaceReport` carrying, per decision, the
**feasible candidate set** — values that participate in at least one
postprocessor-valid completion — plus **lint diagnostics** over the space
definition itself (empty feasible sets, decision-name collisions, splits
whose generator emits blocks the kernel's ``supports_block_shape``
capability rejects, VMEM bounds provably violated for every completion) and,
across a hardware sweep, **dead candidates** that are valid on no config
(:func:`lint_space`).

Three layers consume the report:

- the tuner wraps its program with :func:`pruned_program` so statically-
  infeasible candidates are never proposed (``TuneResult.static_pruned``
  counts the values actually filtered — when it is zero the candidate sets
  were returned untouched and the fixed-seed rng stream is bit-identical to
  the pre-analyzer sampler);
- :class:`~repro_torch.core.database.TuningDatabase` verifies incoming traces
  against the feasible table and quarantines stale ones instead of warm-
  starting searches from garbage;
- the :class:`~repro_torch.core.measure_scheduler.MeasureScheduler`
  refuses to ship statically-invalid work, settling it as ``INVALID``
  without occupying the measurement thread.

The dynamic postprocessors stay the ground truth: ``--suite static`` and
the property tests assert the analyzer's verdicts agree with exhaustive
postprocessor enumeration, so the abstract domain can only ever prune
candidates the dynamic pipeline would have rejected anyway.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core import space as space_lib
from repro_torch.core.hardware import (HardwareConfig, V5E, V5E_MXU256, V5E_VMEM32,
                                 V5E_VMEM64)
from repro_torch.core.schedule import Schedule
from repro_torch.core.space import SpaceProgram
from repro_torch.core.workload import Workload, dtype_bytes

# Lint rules over the space definition (Diagnostic.rule values).
RULE_EMPTY = "empty-feasible-set"
RULE_DEAD = "dead-candidate"
RULE_COLLISION = "name-collision"
RULE_UNCAPABLE = "uncapable-split"
RULE_VMEM = "vmem-always-exceeded"
RULE_GENERATOR = "generator-raises"

# The hardware configurations a space definition is linted across (the
# paper's VLEN-sweep analogue, plus the MXU geometry variant).
DEFAULT_SWEEP = (V5E, V5E_VMEM32, V5E_VMEM64, V5E_MXU256)

# DFS budget: spaces larger than this are reported non-exhaustive (the
# feasible table degrades to permissive and nothing is pruned or
# quarantined on its authority).
DEFAULT_TRACE_LIMIT = 100_000


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One lint finding over a space definition."""

    rule: str
    decision: str  # decision name, or "" for a space-level finding
    message: str

    def __str__(self):
        where = f" [{self.decision}]" if self.decision else ""
        return f"{self.rule}{where}: {self.message}"


def _norm(x: Any) -> Any:
    """Hash-normalize a decision value (JSON round-trips tuples as lists)."""
    if isinstance(x, list):
        return tuple(_norm(v) for v in x)
    return x


@dataclasses.dataclass
class SpaceReport:
    """Static analysis result for one (workload, hardware) design space.

    ``feasible[name]`` holds the values of decision ``name`` that appear in
    at least one postprocessor-valid completion; ``seen[name]`` holds every
    value the decision's candidate generator emitted across all reachable
    contexts. ``exhaustive`` is False when the space exceeded the trace
    limit — the table is then permissive (nothing is pruned, quarantined,
    or refused on its authority).
    """

    workload: Workload
    hw: HardwareConfig
    exhaustive: bool
    total_traces: int
    valid_traces: int
    feasible: dict[str, tuple]
    seen: dict[str, tuple]
    diagnostics: list[Diagnostic]
    # provable lower bound on any completion's VMEM footprint (bytes);
    # None when the abstract pass did not apply (custom program / no splits)
    vmem_floor: int | None = None

    # ---- verdicts --------------------------------------------------------------
    @property
    def infeasible_fraction(self) -> float:
        """Fraction of the raw trace space proven postprocessor-invalid."""
        if not self.exhaustive or self.total_traces <= 0:
            return 0.0
        return 1.0 - self.valid_traces / self.total_traces

    def is_feasible(self, name: str, value: Any) -> bool:
        """Can ``value`` for decision ``name`` appear in any valid
        completion? Permissive for unknown decisions (e.g. v1 ``*_scale``
        names the program doesn't carry) and non-exhaustive analyses."""
        if not self.exhaustive:
            return True
        feas = self.feasible.get(name)
        if feas is None:
            return True
        return _norm(value) in feas

    def check_trace(self, decisions: Mapping[str, Any]) -> str:
        """'' if every decision value could appear in a valid completion,
        else the first provable reason. Per-decision only — a trace whose
        values are all individually feasible may still be jointly invalid;
        the dynamic postprocessors remain responsible for that."""
        for name, value in decisions.items():
            if not self.is_feasible(name, value):
                return (f"decision {name}={value!r} is in no "
                        f"postprocessor-valid completion of "
                        f"{self.workload.key()}@{self.hw.name}")
        return ""

    def check_schedule(self, schedule: Schedule) -> str:
        """:meth:`check_trace` over a schedule's decision dict."""
        return self.check_trace(schedule.as_dict())

    # ---- pruning surface -------------------------------------------------------
    def dead_values(self) -> dict[str, tuple]:
        """Per decision, the candidates emitted somewhere but valid nowhere
        (what :func:`pruned_program` will filter)."""
        if not self.exhaustive:
            return {name: () for name in self.seen}
        return {name: tuple(sorted((set(vals) - set(self.feasible.get(name,
                                                                      ()))),
                                   key=repr))
                for name, vals in self.seen.items()}

    @property
    def pruned_value_count(self) -> int:
        """Total statically-dead (decision, value) pairs in this space."""
        return sum(len(v) for v in self.dead_values().values())


class _Truncated(Exception):
    """DFS exceeded the trace limit; analysis degrades to permissive."""


# =============================================================================
# Abstract pre-pass: per-variant VMEM floors over the divisor/interval domain.
# =============================================================================

def _variant_vmem_floor(workload: Workload, hw: HardwareConfig,
                        program: SpaceProgram, variant: str) -> int | None:
    """Provable lower bound on the VMEM footprint of any completion that
    chose ``variant``, or None when no sound bound is known for this op.

    The tile-split candidate sets are finite divisor sets; the footprint is
    monotone nondecreasing in every block dimension, so evaluating it at
    each dimension's domain minimum bounds every completion from below.
    Only sound for the registered ``space_for`` program shapes (matmul's
    splits depend on the variant alone, so the bound is exact; gemv/vmacc
    later splits condition on earlier ones, so their lower bound uses the
    generator's hard floor — bn >= 1, bc >= lane — and stays sound). The
    footprints are the ones ``space.concretize`` computes and the dynamic
    ``postproc_vmem_fit`` checks (``space.matmul_block_bytes`` for
    matmul)."""
    op = workload.op
    ib = dtype_bytes(workload.dtype)
    ob = dtype_bytes(workload.out_dtype)
    lane = hw.lane_align(workload.dtype)
    ctx = {"variant": variant}
    try:
        if op in ("matmul", "qmatmul"):
            bm = min(program.candidates("bm", ctx))
            bn = min(program.candidates("bn", ctx))
            bk = min(program.candidates("bk", ctx))
            return space_lib.matmul_block_bytes(workload, hw, bm, bn, bk)
        if op == "gemv":
            bk = min(program.candidates("bk", ctx))
            bn = 1  # the J=1 row form is the generator's hard floor
            return bk * ib + bk * bn * ib + bn * ob + 4 * bn
        if op == "vmacc":
            br = min(program.candidates("br", ctx))
            bc = lane  # bc candidates are lane multiples (divisor domain)
            return 4 * br * bc * max(ib, ob)
    except (KeyError, ValueError):
        return None
    return None


def _vmem_dead_variants(workload: Workload, hw: HardwareConfig,
                        program: SpaceProgram
                        ) -> tuple[set[str], int | None]:
    """Variants whose every completion provably exceeds the VMEM budget,
    plus the overall footprint floor across variants (None if unbounded)."""
    if space_lib.postproc_vmem_fit not in program.postprocessors:
        return set(), None
    dead: set[str] = set()
    floors: list[int] = []
    try:
        variants = program.candidates("variant")
    except KeyError:
        return set(), None
    for v in variants:
        floor = _variant_vmem_floor(workload, hw, program, v)
        if floor is None:
            return set(), None  # no sound bound for this op shape
        floors.append(floor)
        if floor > hw.vmem_budget:
            dead.add(v)
    return dead, (min(floors) if floors else None)


# =============================================================================
# Kernel capability cross-check (supports_block_shape).
# =============================================================================

def _capability_check(op: str) -> Callable | None:
    """Per-leaf predicate cross-checking the trace's block against the
    kernel's own lowering capability; returns ``(ok, involved_decisions)``
    or None when the trace doesn't carry the involved decisions. The
    registered generators gate on this already — a failing combination
    means some generator emitted a block the kernel cannot lower. (matmul's
    launch gate is the ``postproc_kernel_support`` postprocessor, as in the
    reference, where matmul has no capability check either.)"""
    if op == "gemv":
        from repro_torch.kernels.gemv import ops as gemv_ops  # lazy

        def check_gemv(trace, lane, sub):
            bn, bk = trace.get("bn"), trace.get("bk")
            if bn is None or bk is None:
                return None
            return (bool(gemv_ops.supports_block_shape(int(bn), int(bk),
                                                       lane)),
                    ("bk", "bn"))
        return check_gemv
    if op == "vmacc":
        from repro_torch.kernels.vmacc import ops as vmacc_ops  # lazy

        def check_vmacc(trace, lane, sub):
            br, bc = trace.get("br"), trace.get("bc")
            if br is None or bc is None:
                return None
            return (bool(vmacc_ops.supports_block_shape(int(br), int(bc),
                                                        sub, lane)),
                    ("br", "bc"))
        return check_vmacc
    return None


# =============================================================================
# The analyzer.
# =============================================================================

_CACHE: dict[tuple[str, str], SpaceReport] = {}
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    """Drop memoized reports (tests that monkeypatch spaces/postprocessors
    or mutate hardware registries must start clean)."""
    with _CACHE_LOCK:
        _CACHE.clear()


def analyze(workload: Workload, hw: HardwareConfig,
            program: SpaceProgram | None = None,
            limit: int = DEFAULT_TRACE_LIMIT) -> SpaceReport:
    """Static analysis of one (workload, hardware) design space.

    With ``program=None`` (the normal case) the registered
    ``space_for(workload, hw)`` program is analyzed and the report is
    memoized per (workload key, hardware name) — "once per (workload,
    hardware)", however many tuner/database/farm layers consult it. An
    explicit ``program`` (tests, custom spaces) is analyzed fresh with the
    abstract VMEM pre-pass disabled (its soundness argument only covers the
    registered program shapes).

    Raises whatever ``space_for`` raises for unregistered op families; use
    :func:`feasibility` for a never-raising variant.
    """
    registered = program is None
    if registered:
        key = (workload.key(), hw.name)
        with _CACHE_LOCK:
            cached = _CACHE.get(key)
        if cached is not None:
            return cached
        program = space_lib.space_for(workload, hw)
    report = _analyze_program(workload, hw, program, limit,
                              abstract=registered)
    if registered:
        with _CACHE_LOCK:
            _CACHE[(workload.key(), hw.name)] = report
    return report


def feasibility(workload: Workload, hw: HardwareConfig) -> SpaceReport | None:
    """Memoized :func:`analyze` that returns None instead of raising —
    the form the tuner/database/farm integration layers call (an op family
    without a registered space simply has no static verdicts)."""
    try:
        return analyze(workload, hw)
    except Exception:
        return None


def _analyze_program(workload: Workload, hw: HardwareConfig,
                     program: SpaceProgram, limit: int,
                     abstract: bool) -> SpaceReport:
    lane = hw.lane_align(workload.dtype)
    sub = hw.sublane_align(workload.dtype)
    names = [ins.name for ins in program.instructions]
    seen: dict[str, set] = {n: set() for n in names}
    feasible: dict[str, set] = {n: set() for n in names}
    uncapable: dict[str, set] = {}
    diagnostics: list[Diagnostic] = []

    # -- space-shape lints that need no enumeration --
    dupes = {n for n in names if names.count(n) > 1}
    for n in sorted(dupes):
        diagnostics.append(Diagnostic(
            RULE_COLLISION, n,
            f"{names.count(n)} instructions share the decision name {n!r}; "
            f"pinning, observation, and feasibility all key by name and "
            f"will silently conflate them"))

    # -- abstract VMEM pre-pass (divisor/interval domain) --
    dead_variants: set[str] = set()
    vmem_floor: int | None = None
    if abstract and not dupes:
        dead_variants, vmem_floor = _vmem_dead_variants(workload, hw, program)

    capability = _capability_check(workload.op) if not dupes else None

    counts = {"total": 0, "valid": 0}
    exhausted = True

    def leaf(ctx: dict) -> None:
        counts["total"] += 1
        if counts["total"] > limit:
            raise _Truncated
        if capability is not None:
            verdict = capability(ctx, lane, sub)
            if verdict is not None and not verdict[0]:
                involved = verdict[1]
                # attribute to the innermost split: its generator saw the
                # full upstream context and still emitted this value
                blame = max(involved, key=names.index)
                uncapable.setdefault(blame, set()).add(_norm(ctx[blame]))
        if ctx.get("variant") in dead_variants:
            return  # provably VMEM-infeasible; skip the dynamic replay
        params = program.validate(Schedule.fixed(**ctx))
        if params.valid:
            counts["valid"] += 1
            for name, value in ctx.items():
                feasible[name].add(_norm(value))

    gen_errors: dict[str, str] = {}

    def walk(i: int, ctx: dict) -> None:
        if i == len(program.instructions):
            leaf(ctx)
            return
        ins = program.instructions[i]
        try:
            cands = ins.candidates(ctx)
        except _Truncated:
            raise
        except Exception as exc:
            # a raising generator is exactly the crash a stale trace would
            # hit at replay time: no completion exists through this
            # context, so upstream values reaching it are simply never
            # marked feasible (and the hazard is surfaced as a diagnostic)
            gen_errors.setdefault(
                ins.name,
                f"candidate generator raised {type(exc).__name__}: {exc} "
                f"under {dict(ctx)!r}")
            return
        for c in cands:
            seen[ins.name].add(_norm(c))
            ctx[ins.name] = c
            walk(i + 1, ctx)
        ctx.pop(ins.name, None)

    try:
        walk(0, {})
    except _Truncated:
        exhausted = False

    if not exhausted:
        # permissive degradation: everything seen counts as feasible, and
        # nothing downstream prunes/quarantines on this report's authority
        return SpaceReport(
            workload, hw, False, counts["total"] - 1, counts["valid"],
            {n: tuple(sorted(seen[n], key=repr)) for n in names},
            {n: tuple(sorted(seen[n], key=repr)) for n in names},
            diagnostics, vmem_floor)

    # -- enumeration-dependent lints --
    for name, message in sorted(gen_errors.items()):
        diagnostics.append(Diagnostic(RULE_GENERATOR, name, message))
    for name, values in sorted(uncapable.items()):
        shown = sorted(values, key=repr)[:6]
        diagnostics.append(Diagnostic(
            RULE_UNCAPABLE, name,
            f"candidate generator emitted {len(values)} value(s) the "
            f"kernel's supports_block_shape capability rejects "
            f"(e.g. {shown}); the generator ignores the capability gate"))
    if counts["valid"] == 0 and vmem_floor is not None \
            and vmem_floor > hw.vmem_budget:
        diagnostics.append(Diagnostic(
            RULE_VMEM, "",
            f"minimum completion footprint {vmem_floor} bytes exceeds the "
            f"VMEM budget {int(hw.vmem_budget)} ({hw.vmem_headroom:.0%} of "
            f"{hw.vmem_capacity}): every completion is provably invalid"))
    for name in names:
        if seen[name] and not feasible[name]:
            diagnostics.append(Diagnostic(
                RULE_EMPTY, name,
                f"no candidate of decision {name!r} appears in any "
                f"postprocessor-valid completion "
                f"({len(seen[name])} candidates, all dead)"))

    return SpaceReport(
        workload, hw, True, counts["total"], counts["valid"],
        {n: tuple(sorted(feasible[n], key=repr)) for n in names},
        {n: tuple(sorted(seen[n], key=repr)) for n in names},
        diagnostics, vmem_floor)


# =============================================================================
# Hardware-sweep lint.
# =============================================================================

def lint_space(workload: Workload,
               hws: Sequence[HardwareConfig] = DEFAULT_SWEEP
               ) -> list[Diagnostic]:
    """Lint one workload's space definition across a hardware sweep.

    Per-config diagnostics are aggregated (tagged with the config name),
    and **dead candidates** — values some config's generator emits but that
    are postprocessor-valid on *no* config in the sweep — are reported once
    per decision: they are pure search-space noise on this hardware
    generation and usually indicate a candidate generator that ignores a
    capability or capacity bound."""
    hws = tuple(hws)
    reports = [analyze(workload, hw) for hw in hws]
    diags: list[Diagnostic] = []
    for hw, rep in zip(hws, reports):
        for d in rep.diagnostics:
            diags.append(dataclasses.replace(
                d, message=f"[{hw.name}] {d.message}"))
    if all(r.exhaustive for r in reports):
        names = list(dict.fromkeys(n for r in reports for n in r.seen))
        for name in names:
            seen = set().union(*(set(r.seen.get(name, ())) for r in reports))
            feas = set().union(*(set(r.feasible.get(name, ()))
                                 for r in reports))
            dead = sorted(seen - feas, key=repr)
            if dead:
                diags.append(Diagnostic(
                    RULE_DEAD, name,
                    f"candidates {dead[:8]} of decision {name!r} are "
                    f"postprocessor-valid on no config in "
                    f"{[h.name for h in hws]}"))
    return diags


# =============================================================================
# Pruned program construction (the tuner-side integration).
# =============================================================================

def pruned_program(program: SpaceProgram, report: SpaceReport,
                   on_prune: Callable[[int], None] | None = None
                   ) -> SpaceProgram:
    """Wrap a program so every candidate set is intersected with the
    report's feasible table before sampling sees it.

    The rng-stream contract: a candidate set with nothing to prune is
    returned as the *same tuple object* the original generator produced, so
    a search in which the analyzer prunes nothing consumes a bit-identical
    rng stream (``TuneResult.static_pruned == 0`` certifies this). When a
    set does shrink, ``on_prune(n_removed)`` is invoked — the counter's
    feed. A filter that would empty a candidate set backs off and returns
    it unpruned (those candidates are all provably invalid; the dynamic
    postprocessors keep rejecting them, exactly as before the analyzer).

    Instruction ``dist`` objects are shared with the original program, so
    proposal learning, priors, and persistence observe the same state."""
    if not report.exhaustive:
        return program
    if not any(report.dead_values().values()):
        return program

    def wrap(ins):
        orig = ins.candidates

        def filtered(ctx, _orig=orig, _name=ins.name):
            cands = _orig(ctx)
            kept = tuple(c for c in cands
                         if report.is_feasible(_name, c))
            if len(kept) == len(cands) or not kept:
                return cands
            if on_prune is not None:
                on_prune(len(cands) - len(kept))
            return kept
        return dataclasses.replace(ins, candidates=filtered)

    return SpaceProgram(program.workload, program.hw,
                        [wrap(ins) for ins in program.instructions],
                        program.postprocessors)
