"""Generative design-space programs with learned per-decision proposals.

The paper's central device is tuning via *probabilistic programs*: a
generative schedule program whose sampling decisions depend on one another,
whose illegal traces are rejected by postprocessors, and whose **proposal
distributions are learned from measured outcomes**. ``space_for`` builds
that program for a workload on a hardware config as a :class:`SpaceProgram`
— an ordered list of sampling instructions (``sample_categorical``,
``sample_tile_split``) executed by a trace interpreter:

- the **intrinsic variant** draw comes first (the paper's multi-VL
  registration);
- **tile-split** draws then condition on it: their candidate sets are the
  true perfect-tile factorizations of the workload's (alignment-padded)
  extents, capped at the chosen variant's base block — pick a different
  variant and the tile candidate sets change. The legacy 3-point ``SCALES``
  grid is embedded as anchors, so the v1 flat space is a strict subset of
  the program space;
- the **accumulate** draw conditions on the chosen k-split: a schedule with
  a single k-step has nothing to re-visit, so only the accumulate-in-VMEM
  form is sampled (Algorithm 1).

Every instruction carries a :class:`DecisionDistribution` — a smoothed
per-candidate categorical posterior over the values this decision has been
observed to choose, under a uniform prior. ``sample``/``replay`` draw
resampled decisions *through* the distribution: with no evidence the draw
is bit-identical to a uniform index draw (uniform prior ⇒ the same
``rng.integers`` stream as the pre-learned sampler), and as measured
outcomes arrive (:meth:`SpaceProgram.observe`, fed rank-relative rewards by
the tuner) the proposals tilt toward decisions that produced fast
schedules. Posterior mass is keyed by candidate *value*, so the dynamic
candidate sets (a different variant ⇒ different tile splits) re-map
cleanly: only the values present in the freshly computed set weigh in.
Distributions serialize (:meth:`SpaceProgram.dists_to_json`) alongside
schedules in the tuning database, and
``TuningDatabase.transfer_distributions`` blends them across shapes and
hardware into a new search's priors — the paper's Fig. 4 transfer
mechanism, upgraded from warm-start traces to warm-start *distributions*.

Mutation and crossover are *trace replay* (:meth:`SpaceProgram.replay`):
pin edited decisions and re-execute the program so dependent candidate sets
refresh and the child trace stays coherent. v1 flat traces (old database
records, :meth:`Schedule.fixed` library schedules) are *adopted* onto a
program the same way — their scale decisions translate to the nearest tile
anchor — preserving the Fig. 4 warm-start transfer path.

Validation is split into a **static** and a **dynamic** half sharing one
set of rules. The static half (:mod:`repro_torch.core.static_analysis`) abstract-
interprets the program once per (workload, hardware) — categorical variants
enumerated exactly, tile splits tracked through the divisor/interval domain
``tile_candidates`` spans — and proves, before any sampling, which decision
values can participate in at least one legal completion; the tuner,
database, and measurement farm consult those feasible sets so provably-dead
candidates are never proposed, warm-started from, or shipped to a board.
The dynamic half is the residual per-candidate check: ``concretize``
replays either trace layout into :class:`KernelParams` — the parameters a
kernel is built and launched from — and runs the composable postprocessor
pipeline (block alignment, non-empty grid, on-chip memory fit against
``HardwareConfig.vmem_headroom`` and, on a CUDA config, the kernel's own
launch gate), marking invalid candidates exactly as
MetaSchedule's postprocessors reject illegal traces. The postprocessors are
the ground truth: the analyzer's verdicts are required to agree with
exhaustive postprocessor enumeration (asserted in ``--suite static`` and
the property tests), so static pruning can only remove candidates the
dynamic pipeline would have rejected anyway.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Iterator, Mapping

from repro_torch.core import intrinsics
from repro_torch.core.hardware import CudaHardwareConfig, HardwareConfig
from repro_torch.core.schedule import (PROV_LEGACY, PROV_PINNED, PROV_SAMPLED,
                                 Decision, Schedule)
from repro_torch.core.workload import Workload, dtype_bytes

# Legacy v1 tile scales — kept both for decoding old flat traces and as the
# anchor points embedded in every tile-split candidate set (the v1 grid is a
# subset of the program space, so program search can never do worse).
SCALES = (1.0, 0.5, 0.25)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Concrete static parameters for one kernel instantiation."""

    op: str
    dims: tuple[int, ...]
    padded_dims: tuple[int, ...]
    block: tuple[int, ...]
    grid: tuple[int, ...]
    order: str  # grid-major order, e.g. "mnk" | "nmk"
    accumulate: bool  # True: VMEM accumulator, store once (Algorithm 1)
    dtype: str
    out_dtype: str
    vmem_bytes: int
    valid: bool
    why_invalid: str = ""

    def signature(self) -> tuple:
        """Canonical content key of this concrete kernel instantiation.

        Covers exactly the values a kernel build consumes — op, shapes,
        block/grid/order, accumulate and dtypes — so two schedules that
        concretize to the same lowering share one signature, whatever
        trace produced them. Purely value-derived (never ``id()`` or a
        default ``repr``): equal params on different objects, processes,
        or sessions hash and compare equal, which is what makes the
        signature usable as a content-addressed cache key across the
        build cache, batch dedup, and the database's measured-latency
        memo. The hardware config is *not* part of the signature (params
        already encode its consequences); layers whose results do depend
        on the hardware beyond the params — e.g. the ``concretize`` memo
        — add ``hw.name`` to their own keys."""
        return (self.op, self.dims, self.padded_dims, self.block, self.grid,
                self.order, self.accumulate, self.dtype, self.out_dtype)


# =============================================================================
# Postprocessors — MetaSchedule's trace-rejection pipeline, composable.
# Each takes (workload, hw, params) and returns "" (legal) or a reason.
# =============================================================================

def postproc_block_alignment(workload: Workload, hw: HardwareConfig,
                             params: KernelParams) -> str:
    """Blocks must respect the hardware tiling grain (sublane x lane)."""
    lane = hw.lane_align(workload.dtype)
    sub = hw.sublane_align(workload.dtype)
    if params.op in ("matmul", "qmatmul"):
        bm, bn, bk = params.block
        if bm % sub or bn % lane or bk % lane:
            return (f"block {params.block} breaks {sub}x{lane} "
                    f"sublane/lane alignment")
    elif params.op == "gemv":
        bn, bk = params.block
        if bk % lane:
            return f"k-block {bk} not a lane multiple ({lane})"
        if bn != 1 and bn % lane:
            # the kernel's (1, bn) output tile: full lanes or the J=1 row
            # form — nothing ragged in between (see gemv supports_block_shape)
            return f"n-block {bn} neither 1 nor a lane multiple ({lane})"
    elif params.op == "vmacc":
        br, bc = params.block
        if br % sub:
            return f"row-block {br} not a sublane multiple ({sub})"
        if bc % lane:
            return f"col-block {bc} not a lane multiple ({lane})"
    return ""


@functools.cache
def kernel_family(op: str):
    """The port's CUDA kernel family for ``op`` (``kernels.family``): its
    launch gate, footprint and floor."""
    from repro_torch import kernels  # lazy: the kernels import this module

    return kernels.family(op)


def postproc_kernel_support(workload: Workload, hw: HardwareConfig,
                            params: KernelParams) -> str:
    """On a CUDA config, the block must be one the port's kernel can launch
    (the family's gate: register accumulator, threads per block, shared
    memory, dp4a depth), so an unlaunchable tile is an invalid candidate,
    not a crash. A no-op on every other config."""
    if not isinstance(hw, CudaHardwareConfig):
        return ""
    if not kernel_family(params.op).gate(workload, params.block, hw):
        return f"block {params.block} not launchable by the CUDA kernel"
    return ""


def postproc_nonempty_grid(workload: Workload, hw: HardwareConfig,
                           params: KernelParams) -> str:
    for g in params.grid:
        if g <= 0:
            return f"empty grid {params.grid}"
    return ""


def postproc_vmem_fit(workload: Workload, hw: HardwareConfig,
                      params: KernelParams) -> str:
    # The headroom-derated capacity lives on the hardware config
    # (``HardwareConfig.vmem_headroom``) so this dynamic check and the
    # static analyzer's interval-domain bound can never drift apart.
    if params.vmem_bytes > hw.vmem_budget:
        return (f"vmem footprint {params.vmem_bytes} exceeds "
                f"{hw.vmem_headroom:.0%} of {hw.vmem_capacity}")
    return ""


DEFAULT_POSTPROCESSORS = (postproc_block_alignment, postproc_nonempty_grid,
                          postproc_vmem_fit, postproc_kernel_support)


def apply_postprocessors(workload: Workload, hw: HardwareConfig,
                         params: KernelParams,
                         postprocessors=DEFAULT_POSTPROCESSORS) -> KernelParams:
    """Run the rejection pipeline; the first failing check invalidates."""
    for post in postprocessors:
        why = post(workload, hw, params)
        if why:
            return dataclasses.replace(params, valid=False, why_invalid=why)
    return params


# =============================================================================
# Learned proposal distributions.
# =============================================================================

class DecisionDistribution:
    """Per-candidate categorical posterior for one sampling decision.

    Evidence is reward *mass* and observation *count* keyed by candidate
    value (``observe``: one measured trace contributed ``reward`` to the
    value its decision chose). Each candidate's score is its posterior-mean
    reward — ``(0.5*alpha + mass) / (alpha + count)``, a Beta-style estimate
    smoothed toward the neutral reward 0.5 by ``alpha`` pseudo-observations
    — and the proposal over a concrete candidate set normalizes those
    scores. Mean reward (not total mass) is deliberate: a value sampled
    often with mediocre outcomes must not outweigh a value sampled once
    with an excellent one. Properties:

    - **no evidence ⇒ exactly uniform**: every score is 0.5, and drawing
      falls back to the plain ``rng.integers(len(cands))`` index draw,
      bit-identical to the pre-learned sampler (the determinism contract
      the tuner tests pin);
    - **value-keyed re-mapping**: candidate sets are dynamic (they condition
      on upstream choices), so scores are looked up per value — a value
      absent from the current set simply doesn't participate, and evidence
      survives candidate-set changes without index bookkeeping;
    - **transferable**: evidence is plain ``{value: float}`` data, so
      posteriors blend across shapes/hardware (``seed_prior`` folds a
      foreign posterior in as ``strength`` pseudo-observations — the
      Fig. 4 warm-start mechanism on distributions instead of traces).
    """

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha
        self.mass: dict[Any, float] = {}   # accumulated reward per value
        self.count: dict[Any, float] = {}  # observations per value

    # ---- evidence ----------------------------------------------------------
    def observe(self, value: Any, reward: float) -> None:
        """Fold one measured outcome in. ``reward`` must be >= 0 (the tuner
        uses rank-relative latency in (0, 1), so scale-free across analytic
        and real-board runners)."""
        if not (reward >= 0.0) or not math.isfinite(reward):
            return
        self.mass[value] = self.mass.get(value, 0.0) + reward
        self.count[value] = self.count.get(value, 0.0) + 1.0

    def seed_prior(self, weights: Mapping[Any, float],
                   strength: float = 8.0) -> None:
        """Blend a foreign posterior in as ``strength`` pseudo-observations,
        split evenly across its positive-weight values, each carrying a
        synthetic reward proportional to its weight (the best transferred
        value gets reward 1.0, the rest scale down) — so relative ordering
        transfers without frequency bias. Values the current program never
        offers simply never match a candidate set."""
        pos = {v: w for v, w in weights.items()
               if w > 0 and math.isfinite(w)}
        if not pos or strength <= 0:
            return
        top = max(pos.values())
        share = strength / len(pos)
        for v, w in pos.items():
            self.mass[v] = self.mass.get(v, 0.0) + share * (w / top)
            self.count[v] = self.count.get(v, 0.0) + share

    def evidence(self, cands: tuple) -> float:
        """Total observation count the values of this candidate set carry."""
        return sum(self.count.get(c, 0.0) for c in cands)

    @property
    def n_observations(self) -> float:
        return sum(self.count.values())

    # ---- posterior ---------------------------------------------------------
    def weights(self, cands: tuple) -> list[float]:
        """Normalized proposal over ``cands``: each candidate's smoothed
        posterior-mean reward, normalized. No evidence ⇒ exactly uniform."""
        a = max(self.alpha, 1e-9)
        raw = [(0.5 * a + self.mass.get(c, 0.0))
               / (a + self.count.get(c, 0.0)) for c in cands]
        total = sum(raw)
        return [r / total for r in raw]

    def draw(self, cands: tuple, rng) -> Any:
        """Draw one candidate. With no evidence among ``cands`` (or a
        singleton set) this is the legacy uniform index draw — the same
        ``rng.integers`` call, consuming the identical rng stream — so an
        unevidenced program samples bit-identically to the pre-learned
        sampler. With evidence, an inverse-CDF draw over the posterior."""
        if len(cands) <= 1 or self.evidence(cands) <= 0.0:
            return cands[int(rng.integers(len(cands)))]
        u = float(rng.random())
        acc = 0.0
        w = self.weights(cands)
        for c, wi in zip(cands, w):
            acc += wi
            if u < acc:
                return c
        return cands[-1]

    def entropy(self, cands: tuple) -> float:
        """Normalized Shannon entropy of the posterior over ``cands``:
        1.0 = uniform (nothing learned), -> 0 as the proposal converges on
        one candidate; 0.0 for singleton sets."""
        if len(cands) <= 1:
            return 0.0
        h = -sum(wi * math.log(wi) for wi in self.weights(cands) if wi > 0)
        return h / math.log(len(cands))

    # ---- io ------------------------------------------------------------------
    def to_json(self) -> dict:
        items = sorted(self.mass.items(), key=lambda kv: str(kv[0]))
        return {"alpha": self.alpha,
                "values": [v for v, _ in items],
                "mass": [m for _, m in items],
                "count": [self.count.get(v, 0.0) for v, _ in items]}

    @staticmethod
    def from_json(payload: Mapping) -> "DecisionDistribution":
        d = DecisionDistribution(alpha=float(payload.get("alpha", 1.0)))
        counts = payload.get("count", [])
        for i, (v, m) in enumerate(zip(payload["values"], payload["mass"])):
            v = _dist_key(v)
            d.mass[v] = float(m)
            if i < len(counts) and counts[i]:
                d.count[v] = float(counts[i])
        return d

    def __repr__(self):
        return (f"DecisionDistribution(n={self.n_observations:g}, "
                f"support={len(self.mass)})")


def _dist_key(x):
    # JSON round-trips tuples as lists; candidate values must hash.
    if isinstance(x, list):
        return tuple(_dist_key(v) for v in x)
    return x


# =============================================================================
# Sampling instructions and the trace interpreter.
# =============================================================================

SAMPLE_CATEGORICAL = "sample_categorical"
SAMPLE_TILE_SPLIT = "sample_tile_split"

# Candidate sets are functions of the choices made so far (the generative
# part); legacy hooks translate a v1 flat trace into a proposal for this
# decision, given both the old trace and the replay context so far (the
# adoption part).
Context = Mapping[str, Any]
CandidatesFn = Callable[[Context], tuple]
LegacyFn = Callable[[Context, Context], Any]


@dataclasses.dataclass(frozen=True)
class Instruction:
    """One sampling site of a generative schedule program."""

    name: str
    kind: str  # SAMPLE_CATEGORICAL | SAMPLE_TILE_SPLIT
    candidates: CandidatesFn
    legacy: LegacyFn | None = None  # v1-trace translation hook
    # the learned proposal: mutable evidence carried by a frozen site
    dist: DecisionDistribution = dataclasses.field(
        default_factory=DecisionDistribution, compare=False)


def sample_categorical(name: str, candidates, legacy=None) -> Instruction:
    fn = candidates if callable(candidates) else (
        lambda ctx, _c=tuple(candidates): _c)
    return Instruction(name, SAMPLE_CATEGORICAL, fn, legacy)


def sample_tile_split(name: str, candidates: CandidatesFn,
                      legacy: LegacyFn | None = None) -> Instruction:
    return Instruction(name, SAMPLE_TILE_SPLIT, candidates, legacy)


# Pure in its three integers, and called for every replayed decision of the
# search: memoized.
@functools.lru_cache(maxsize=4096)
def tile_candidates(extent: int, align: int, base: int) -> tuple[int, ...]:
    """Perfect-tile block candidates for one loop extent.

    All ``align``-multiples that exactly divide the alignment-padded extent
    (true factorization — the grid covers the padded loop with zero extra
    padding), capped at the variant's base block ``base`` (a variant is a
    granularity ceiling, as VL caps the paper's intrinsics), plus the legacy
    v1 ``SCALES`` anchors of ``base`` so the flat space embeds."""
    padded = round_up(extent, align)
    cap = max(align, base)
    cands = {d for d in range(align, min(cap, padded) + 1, align)
             if padded % d == 0}
    for s in SCALES:
        cands.add(_scaled(base, s, align, extent))
    return tuple(sorted(cands))


class SpaceProgram:
    """A generative design-space program: ordered sampling instructions
    executed by a trace interpreter, where later instructions' candidate
    sets may condition on earlier choices.

    Execution modes (all deterministic given the rng state):

    - :meth:`sample` — run the program drawing every decision fresh;
    - :meth:`replay` — run the program keeping pinned decisions whose value
      is still in the (freshly computed) candidate set and resampling the
      rest: the mutation/crossover primitive;
    - :meth:`adopt` — replay an existing trace (v1 flat or v2) onto this
      program, translating legacy decisions through the instructions'
      ``legacy`` hooks (database warm-start transfer).
    """

    def __init__(self, workload: Workload, hw: HardwareConfig,
                 instructions: list[Instruction],
                 postprocessors=DEFAULT_POSTPROCESSORS):
        self.workload = workload
        self.hw = hw
        self.instructions = tuple(instructions)
        self.postprocessors = tuple(postprocessors)

    # ---- introspection -------------------------------------------------------
    def names(self) -> list[str]:
        return [ins.name for ins in self.instructions]

    def candidates(self, name: str, ctx: Context | None = None) -> tuple:
        """Candidate set of one decision given upstream ``ctx`` choices;
        missing upstream choices default to each instruction's first
        candidate (the "default prefix")."""
        ctx = dict(ctx or {})
        for ins in self.instructions:
            cands = ins.candidates(ctx)
            if ins.name == name:
                return tuple(cands)
            ctx.setdefault(ins.name, cands[0])
        raise KeyError(name)

    def __getitem__(self, name: str) -> tuple:
        """Candidate set under the default prefix (``program["variant"]`` is
        the full variant ladder — the common introspection)."""
        return self.candidates(name)

    def __len__(self) -> int:
        return len(self.instructions)

    # ---- trace interpreter ---------------------------------------------------
    def replay(self, pinned: Mapping[str, Any], rng,
               legacy: Mapping[str, Any] | None = None) -> Schedule:
        """Execute the program: keep each pinned decision if its value is in
        the freshly computed candidate set, else translate via the legacy
        hook (nearest candidate), else resample. Downstream candidate sets
        are always recomputed from upstream outcomes, so the returned trace
        is coherent by construction."""
        ctx: dict[str, Any] = {}
        decisions: list[Decision] = []
        for ins in self.instructions:
            cands = tuple(ins.candidates(ctx))
            if not cands:
                raise RuntimeError(
                    f"instruction {ins.name} produced no candidates "
                    f"(ctx {ctx}) for {self.workload.key()}")
            choice, prov = None, ""
            if ins.name in pinned and _contains(cands, pinned[ins.name]):
                choice, prov = pinned[ins.name], PROV_PINNED
            elif legacy is not None and ins.legacy is not None:
                proposed = ins.legacy(legacy, ctx)
                if proposed is not None:
                    choice, prov = _snap(proposed, cands), PROV_LEGACY
            if choice is None:
                choice = ins.dist.draw(cands, rng)
                prov = PROV_SAMPLED
            ctx[ins.name] = choice
            decisions.append(Decision(ins.name, choice, cands, prov))
        return Schedule(tuple(decisions), version=2)

    def sample(self, rng) -> Schedule:
        return self.replay({}, rng)

    def adopt(self, schedule: Schedule, rng) -> Schedule:
        """Replay an existing trace onto this program. v2 traces pin
        directly; v1 flat traces (old database records, library schedules,
        foreign-hardware transfers) translate through the legacy hooks.
        Decisions that no longer fit (e.g. an unregistered variant) are
        resampled, so the result is always a coherent program trace."""
        d = schedule.as_dict()
        return self.replay(d, rng, legacy=d)

    # ---- learned proposals ---------------------------------------------------
    def dist(self, name: str) -> DecisionDistribution | None:
        """The proposal distribution of one decision (None if unknown)."""
        for ins in self.instructions:
            if ins.name == name:
                return ins.dist
        return None

    def observe(self, schedule: Schedule, reward: float) -> None:
        """Feed one measured outcome back into the proposals of every
        decision this trace made (the tuner calls this with a rank-relative
        reward each time a measurement lands)."""
        d = schedule.as_dict()
        for ins in self.instructions:
            if ins.name in d:
                ins.dist.observe(d[ins.name], reward)

    def seed_priors(self, priors: Mapping[str, Mapping[Any, float]],
                    strength: float = 8.0) -> None:
        """Warm-start the proposals from transferred posteriors
        (``TuningDatabase.transfer_distributions`` output): each named
        decision's weights blend in as ``strength`` pseudo-observations."""
        for ins in self.instructions:
            w = priors.get(ins.name)
            if w:
                ins.dist.seed_prior(w, strength)

    def proposal_entropy(self) -> dict[str, float]:
        """Normalized posterior entropy per decision, evaluated along the
        *mode* prefix (each upstream choice fixed to its highest-weight
        candidate; uniform posteriors fall back to the first candidate, the
        old default prefix). 1.0 = still uniform, -> 0 = converged."""
        ctx: dict[str, Any] = {}
        out: dict[str, float] = {}
        for ins in self.instructions:
            cands = tuple(ins.candidates(ctx))
            out[ins.name] = ins.dist.entropy(cands)
            w = ins.dist.weights(cands)
            mode = max(range(len(cands)), key=lambda i: (w[i], -i))
            ctx[ins.name] = cands[mode]
        return out

    def dists_to_json(self) -> dict[str, dict]:
        """Serialize every decision's proposal that carries evidence."""
        return {ins.name: ins.dist.to_json()
                for ins in self.instructions if ins.dist.mass}

    def load_dists(self, payload: Mapping[str, Mapping]) -> None:
        """Restore serialized proposals (inverse of :meth:`dists_to_json`)."""
        for ins in self.instructions:
            blob = payload.get(ins.name)
            if blob:
                restored = DecisionDistribution.from_json(blob)
                ins.dist.alpha = restored.alpha
                ins.dist.mass = restored.mass
                ins.dist.count = restored.count

    # ---- validation ----------------------------------------------------------
    def validate(self, schedule: Schedule) -> KernelParams:
        """Concretize + run this program's postprocessor pipeline."""
        return concretize(self.workload, self.hw, schedule,
                          postprocessors=self.postprocessors)

    # ---- enumeration ---------------------------------------------------------
    def traces(self, limit: int = 1_000_000) -> Iterator[dict[str, Any]]:
        """Depth-first enumeration of every trace (as a decision dict)."""
        n_out = 0

        def rec(i: int, ctx: dict) -> Iterator[dict]:
            nonlocal n_out
            if i == len(self.instructions):
                n_out += 1
                yield dict(ctx)
                return
            ins = self.instructions[i]
            for c in ins.candidates(ctx):
                if n_out >= limit:
                    return
                ctx[ins.name] = c
                yield from rec(i + 1, ctx)
            ctx.pop(ins.name, None)

        yield from rec(0, {})

    def cardinality(self, limit: int = 1_000_000) -> int:
        """Number of traces the program can generate (dependent candidate
        sets make this a DFS count, not a product)."""
        return sum(1 for _ in self.traces(limit))

    def distinct_configs(self, limit: int = 1_000_000) -> int:
        """Number of *distinct, postprocessor-valid* concrete kernel
        configurations reachable — the honest space-size metric (nominal
        trace counts overstate flat spaces whose scales clamp together)."""
        seen = set()
        for t in self.traces(limit):
            p = self.validate(Schedule.fixed(**t))
            if p.valid:
                seen.add(config_key(p))
        return len(seen)

    @staticmethod
    def from_flat(space: Mapping[str, tuple], workload: Workload | None = None,
                  hw: HardwareConfig | None = None) -> "SpaceProgram":
        """Wrap a flat ``{name: candidates}`` dict as a program of
        independent categorical draws (v1 spaces, ad-hoc test spaces)."""
        ins = [sample_categorical(name, tuple(cands))
               for name, cands in space.items()]
        return SpaceProgram(workload, hw, ins)

    def __repr__(self):
        kinds = ", ".join(f"{i.name}:{i.kind.split('_')[-1]}"
                          for i in self.instructions)
        return f"SpaceProgram({kinds})"


def _contains(cands: tuple, value: Any) -> bool:
    return value in cands


def _snap(value: Any, cands: tuple) -> Any:
    """Nearest candidate to a (numeric) proposal; exact match otherwise."""
    if _contains(cands, value):
        return value
    if isinstance(value, (int, float)) and not isinstance(value, bool) and \
            all(isinstance(c, (int, float)) and not isinstance(c, bool)
                for c in cands):
        return min(cands, key=lambda c: (abs(c - value), c))
    return None


# =============================================================================
# Per-op-family program construction.
# =============================================================================

def _variant_names(workload: Workload, hw: HardwareConfig) -> tuple[str, ...]:
    return tuple(v.name for v in intrinsics.variants_for(workload, hw))


def _variant_block(workload: Workload, hw: HardwareConfig, name: str):
    for v in intrinsics.variants_for(workload, hw):
        if v.name == name:
            return v.block
    raise KeyError(f"variant {name} not registered for {workload.key()}")


def _scaled(base: int, scale: float, align: int, cap: int) -> int:
    b = max(align, int(base * scale) // align * align)
    return min(b, max(align, round_up(cap, align)))


def space_for(workload: Workload, hw: HardwareConfig) -> SpaceProgram:
    """The generative design-space program of a workload on a hardware
    config — the probabilistic program MetaSchedule would sample. Decisions
    compose the intrinsic-variant choice (the paper's multi-VL registration)
    with variant-conditioned perfect-tile splits, loop order, and the
    k-split-conditioned accumulate-in-registers choice of Algorithm 1."""
    names = _variant_names(workload, hw)
    lane = hw.lane_align(workload.dtype)
    sub = hw.sublane_align(workload.dtype)
    block = lambda ctx: _variant_block(workload, hw, ctx["variant"])  # noqa: E731

    def legacy_tile(scale_name: str, dim_index: int, extent: int, align: int):
        """v1 ``*_scale`` decision -> concrete tile proposal, using the v1
        formula against the *replayed* variant's base block (the trace's own
        variant may be foreign and already resampled)."""
        def hook(trace: Context, ctx: Context):
            scale = trace.get(scale_name)
            if scale is None:
                return None
            return _scaled(block(ctx)[dim_index], float(scale), align, extent)
        return hook

    ins = [sample_categorical("variant", names)]
    if workload.op in ("matmul", "qmatmul"):
        m, n, k = workload.dims
        ins += [
            sample_tile_split(
                "bm", lambda ctx: tile_candidates(m, sub, block(ctx)[0]),
                legacy=legacy_tile("m_scale", 0, m, sub)),
            sample_tile_split(
                "bn", lambda ctx: tile_candidates(n, lane, block(ctx)[1]),
                legacy=legacy_tile("n_scale", 1, n, lane)),
            sample_tile_split(
                "bk", lambda ctx: tile_candidates(k, lane, block(ctx)[2]),
                legacy=legacy_tile("k_scale", 2, k, lane)),
            sample_categorical("order", ("mnk", "nmk")),
            sample_categorical(
                "accumulate",
                lambda ctx: ((True,) if round_up(k, ctx["bk"]) == ctx["bk"]
                             else (True, False))),
        ]
    elif workload.op == "gemv":
        n, k = workload.dims

        def bn_candidates(ctx):
            """Output-row (J) split: any perfect tile of the padded n
            extent the kernel can actually lower — gated by the kernel's
            own block-shape capability (``supports_block_shape``), up to
            8x the variant's base rows. The J=1 fallback variant stays a
            single-row kernel (its whole point), as does a single-row
            workload (n = 1, what the v1 path produced for it)."""
            from repro_torch.kernels.gemv import ops as gemv_ops  # lazy

            base_bn = block(ctx)[0]
            if base_bn <= 1 or n <= 1:
                return (1,)
            cands = tuple(
                c for c in tile_candidates(n, lane, 8 * base_bn)
                if gemv_ops.supports_block_shape(c, ctx["bk"], lane))
            return cands or (base_bn,)

        def legacy_bn(trace, ctx):
            """v1 traces never split bn: reproduce the variant-derived
            value the legacy concretize path computes, bit-identically —
            including its min(base, n) clamp (n = 1 must stay bn = 1)."""
            base_bn = block(ctx)[0]
            if base_bn <= 1 or min(base_bn, n) <= 1:
                return 1
            return _scaled(base_bn, 1.0, min(lane, base_bn), n)

        ins += [
            sample_tile_split(
                "bk", lambda ctx: tile_candidates(k, lane, block(ctx)[1]),
                legacy=legacy_tile("k_scale", 1, k, lane)),
            sample_tile_split("bn", bn_candidates, legacy=legacy_bn),
            sample_categorical(
                "accumulate",
                lambda ctx: ((True,) if round_up(k, ctx["bk"]) == ctx["bk"]
                             else (True, False))),
        ]
    elif workload.op == "vmacc":
        r, c = workload.dims

        def bc_candidates(ctx):
            """Column split: any perfect tile of the padded c extent the
            kernel can actually lower — gated by the kernel's own
            block-shape capability (``supports_block_shape``), capped at
            the variant's base columns."""
            from repro_torch.kernels.vmacc import ops as vmacc_ops  # lazy

            base_bc = block(ctx)[1]
            cands = tuple(
                cc for cc in tile_candidates(c, lane, base_bc)
                if vmacc_ops.supports_block_shape(ctx["br"], cc, sub, lane))
            return cands or (_scaled(base_bc, 1.0, lane, c),)

        def legacy_bc(trace, ctx):
            """v1 traces never split bc: reproduce the variant-derived value
            the legacy concretize path computes, bit-identically (it is the
            1.0 SCALES anchor tile_candidates embeds, so always present)."""
            return _scaled(block(ctx)[1], 1.0, lane, c)

        ins += [
            sample_tile_split(
                "br", lambda ctx: tile_candidates(r, sub, block(ctx)[0]),
                legacy=legacy_tile("r_scale", 0, r, sub)),
            sample_tile_split("bc", bc_candidates, legacy=legacy_bc),
        ]
    elif workload.op == "attention":
        pass  # the variant ladder is the whole space (block_q x block_kv)
    else:
        raise ValueError(f"unknown op {workload.op}")
    return SpaceProgram(workload, hw, ins)


def flat_space_v1(workload: Workload, hw: HardwareConfig) -> dict[str, tuple]:
    """The pre-program flat decision space (independent categorical draws,
    3-point SCALES tile grid). Kept for space-size comparisons and for
    decoding what old databases were sampled from."""
    names = _variant_names(workload, hw)
    if workload.op in ("matmul", "qmatmul"):
        return {
            "variant": names,
            "m_scale": SCALES,
            "n_scale": SCALES,
            "k_scale": SCALES,
            "order": ("mnk", "nmk"),
            "accumulate": (True, False),
        }
    if workload.op == "gemv":
        return {
            "variant": names,
            "k_scale": SCALES,
            "accumulate": (True, False),
        }
    if workload.op == "vmacc":
        return {
            "variant": names,
            "r_scale": SCALES,
        }
    if workload.op == "attention":
        return {
            "variant": names,
        }
    raise ValueError(f"unknown op {workload.op}")


def config_key(params: KernelParams) -> tuple:
    """Identity of a concrete kernel configuration, for space-size counts.
    ``accumulate`` is normalized away when there is a single reduction step
    (the two forms lower to the same kernel behaviour)."""
    acc = params.accumulate
    if params.op in ("matmul", "qmatmul", "gemv") and params.grid[-1] == 1:
        acc = True
    return (params.op, params.block, params.grid, params.order, acc)


def v1_distinct_configs(workload: Workload, hw: HardwareConfig) -> int:
    """Distinct valid concrete configurations of the v1 flat space (scale
    clamping collapses many nominal traces onto one block shape)."""
    return SpaceProgram.from_flat(flat_space_v1(workload, hw), workload,
                                  hw).distinct_configs()


# =============================================================================
# Concretization — trace -> KernelParams, for both trace layouts.
# =============================================================================

# Memo for the default-pipeline concretize path. Keyed purely by value —
# (workload key, hardware name, schedule signature) — because the function
# is pure in those inputs: KernelParams is frozen, so sharing one instance
# across callers is safe. Bounded LRU: the static analyzer's exhaustive DFS
# can push tens of thousands of distinct traces through ``validate`` per
# (workload, hardware), so an unbounded dict would grow without limit;
# evictions only cost a recompute. Cleared by ``clear_concretize_cache``
# (tests that monkeypatch the intrinsic variant registry must start clean,
# same contract as ``static_analysis.clear_cache``).
_CONCRETIZE_CAPACITY = 4096
_concretize_memo: collections.OrderedDict = collections.OrderedDict()
_concretize_lock = threading.Lock()
_concretize_stats = {"hits": 0, "misses": 0, "evictions": 0}


def concretize_cache_stats() -> dict:
    """Snapshot of the concretize memo counters (hits/misses/evictions
    since process start or the last ``clear_concretize_cache``)."""
    with _concretize_lock:
        out = dict(_concretize_stats)
        out["size"] = len(_concretize_memo)
        out["capacity"] = _CONCRETIZE_CAPACITY
        return out


def clear_concretize_cache() -> None:
    """Drop the concretize memo and reset its counters."""
    with _concretize_lock:
        _concretize_memo.clear()
        for k in _concretize_stats:
            _concretize_stats[k] = 0


def concretize(workload: Workload, hw: HardwareConfig, schedule: Schedule,
               postprocessors=DEFAULT_POSTPROCESSORS) -> KernelParams:
    """Replay a schedule trace into concrete kernel parameters.

    Supports both layouts: v2 program traces carry explicit tile decisions
    (``bm``/``bn``/``bk``/``br``); v1 flat traces carry ``*_scale``
    decisions interpreted against the variant's base block (the legacy
    formula, unchanged — old database records concretize bit-identically).

    The default-pipeline path is memoized per (workload key, hardware name,
    schedule signature) in a bounded LRU — concretize is a pure function of
    those values, and the analytic runner, the tuner's validity/elite
    checks, dispatch, and the static analyzer all re-derive the same params
    many times per search. A non-default ``postprocessors`` pipeline
    bypasses the memo entirely (its verdicts are not a function of the key).
    """
    if postprocessors is not DEFAULT_POSTPROCESSORS:
        return _concretize(workload, hw, schedule, postprocessors)
    key = (workload.key(), hw.name, schedule.signature())
    with _concretize_lock:
        cached = _concretize_memo.get(key)
        if cached is not None:
            _concretize_memo.move_to_end(key)
            _concretize_stats["hits"] += 1
            return cached
    params = _concretize(workload, hw, schedule, postprocessors)
    with _concretize_lock:
        _concretize_stats["misses"] += 1
        _concretize_memo[key] = params
        _concretize_memo.move_to_end(key)
        while len(_concretize_memo) > _CONCRETIZE_CAPACITY:
            _concretize_memo.popitem(last=False)
            _concretize_stats["evictions"] += 1
    return params


def matmul_block_bytes(workload: Workload, hw: HardwareConfig, bm: int,
                       bn: int, bk: int) -> int:
    """On-chip bytes of one (bm, bn, bk) matmul block.

    TPU configs: the x and w blocks, the output block and the f32 VMEM
    accumulator. CUDA configs: the shared memory the kernel's launch at the
    workload's shape asks for (the family's footprint; the accumulator is
    in registers). Nondecreasing in each block dimension except qmatmul's
    on CUDA, whose wgmma loop sizes its ring to the card: the static
    analyzer takes the family's floor."""
    if isinstance(hw, CudaHardwareConfig):
        return kernel_family(workload.op).footprint(workload, (bm, bn, bk),
                                                    hw)
    ib = dtype_bytes(workload.dtype)
    ob = dtype_bytes(workload.out_dtype)
    return bm * bk * ib + bk * bn * ib + bm * bn * ob + bm * bn * 4


def gemv_block_bytes(workload: Workload, hw: HardwareConfig, bn: int,
                     bk: int) -> int:
    """On-chip bytes of one (bn, bk) gemv block — nondecreasing in each
    block dimension (the static analyzer's floor relies on it).

    TPU configs: the x and w blocks, the output block and the f32 VMEM
    accumulator. CUDA configs: the shared memory the kernel asks for (its
    sums are in registers, w streams through them)."""
    if isinstance(hw, CudaHardwareConfig):
        return kernel_family("gemv").footprint(workload, (bn, bk), hw)
    ib = dtype_bytes(workload.dtype)
    ob = dtype_bytes(workload.out_dtype)
    return bk * ib + bk * bn * ib + bn * ob + bn * 4


def vmacc_block_bytes(workload: Workload, hw: HardwareConfig, br: int,
                      bc: int) -> int:
    """On-chip bytes of one (br, bc) vmacc block — nondecreasing in each
    block dimension (the static analyzer's floor relies on it).

    TPU configs: the a, b, c and output blocks at the wider of the input
    and output dtypes. CUDA configs: the shared memory the kernel asks for
    (none: it works in registers)."""
    if isinstance(hw, CudaHardwareConfig):
        return kernel_family("vmacc").footprint(workload, (br, bc), hw)
    ib = dtype_bytes(workload.dtype)
    ob = dtype_bytes(workload.out_dtype)
    return 4 * br * bc * max(ib, ob)


def attention_block_bytes(workload: Workload, hw: HardwareConfig, bq: int,
                          bkv: int, pd: int) -> int:
    """On-chip bytes of one (bq, bkv) attention block at padded head dim
    ``pd`` — nondecreasing in each block dimension.

    TPU configs: the q, k and v blocks, the f32 output accumulator, the
    128-wide running max and sum scratch and the f32 score tile. CUDA
    configs: the shared memory the kernel asks for."""
    if isinstance(hw, CudaHardwareConfig):
        return kernel_family("attention").footprint(workload, (bq, bkv), hw)
    ib = dtype_bytes(workload.dtype)
    return (bq * pd * ib + 2 * bkv * pd * ib + bq * pd * 4
            + 2 * bq * 128 * 4 + bq * bkv * 4)


def _concretize(workload: Workload, hw: HardwareConfig, schedule: Schedule,
                postprocessors=DEFAULT_POSTPROCESSORS) -> KernelParams:
    """The uncached concretization body (see :func:`concretize`)."""
    op, dims = workload.op, workload.dims
    lane = hw.lane_align(workload.dtype)
    sub = hw.sublane_align(workload.dtype)
    try:
        base = _variant_block(workload, hw, schedule["variant"])
    except KeyError:
        # A schedule tuned for another hardware config can reference a
        # variant not registered here (e.g. a VMEM-128 tile on a VMEM-32
        # part) — an invalid candidate, not an error (paper Fig. 4: foreign
        # schedules don't transfer).
        return KernelParams(op, dims, dims, (1,) * len(dims),
                            (1,) * len(dims), "", True, workload.dtype,
                            workload.out_dtype, 0, False,
                            f"variant {schedule['variant']} not registered")

    if op in ("matmul", "qmatmul"):
        m, n, k = dims
        if schedule.get("bm") is not None:  # v2 program trace
            bm, bn, bk = (int(schedule["bm"]), int(schedule["bn"]),
                          int(schedule["bk"]))
        else:  # v1 flat trace
            bm = _scaled(base[0], schedule.get("m_scale", 1.0), sub, m)
            bn = _scaled(base[1], schedule.get("n_scale", 1.0), lane, n)
            bk = _scaled(base[2], schedule.get("k_scale", 1.0), lane, k)
        pm, pn, pk = round_up(m, bm), round_up(n, bn), round_up(k, bk)
        grid_mn = (pm // bm, pn // bn)
        order = schedule.get("order", "mnk")
        if order == "nmk":
            grid = (grid_mn[1], grid_mn[0], pk // bk)
        else:
            grid = (grid_mn[0], grid_mn[1], pk // bk)
        acc = bool(schedule.get("accumulate", True))
        vmem = matmul_block_bytes(workload, hw, bm, bn, bk)
        params = KernelParams(op, dims, (pm, pn, pk), (bm, bn, bk), grid,
                              order, acc, workload.dtype, workload.out_dtype,
                              vmem, True)
    elif op == "gemv":
        n, k = dims
        if schedule.get("bn") is not None:  # v2 program trace: bn split
            bn = max(1, int(schedule["bn"]))
        else:  # v1 flat trace: bn is variant-derived, never split
            bn = max(1, min(base[0], round_up(n, 1)))
            if bn > 1:
                bn = _scaled(base[0], 1.0, min(lane, base[0]), n)
        if schedule.get("bk") is not None:  # v2 program trace
            bk = int(schedule["bk"])
        else:
            bk = _scaled(base[1], schedule.get("k_scale", 1.0), lane, k)
        pn, pk = round_up(n, bn), round_up(k, bk)
        grid = (pn // bn, pk // bk)
        acc = bool(schedule.get("accumulate", True))
        vmem = gemv_block_bytes(workload, hw, bn, bk)
        params = KernelParams(op, dims, (pn, pk), (bn, bk), grid, "nk", acc,
                              workload.dtype, workload.out_dtype, vmem, True)
    elif op == "vmacc":
        r, c = dims
        if schedule.get("br") is not None:  # v2 program trace
            br = int(schedule["br"])
        else:
            br = _scaled(base[0], schedule.get("r_scale", 1.0), sub, r)
        if schedule.get("bc") is not None:  # v2 program trace: bc split
            bc = int(schedule["bc"])
        else:  # v1 flat trace: bc is variant-derived, never split
            bc = _scaled(base[1], 1.0, lane, c)
        pr, pc = round_up(r, br), round_up(c, bc)
        grid = (pr // br, pc // bc)
        vmem = vmacc_block_bytes(workload, hw, br, bc)
        params = KernelParams(op, dims, (pr, pc), (br, bc), grid, "rc", True,
                              workload.dtype, workload.out_dtype, vmem, True)
    elif op == "attention":
        b, hq, hkv, ql, kl, d = dims
        bq, bkv = base
        bq = min(bq, round_up(ql, lane) if ql >= lane else round_up(ql, sub))
        bkv = min(bkv, round_up(kl, lane))
        pq, pkv = round_up(ql, bq), round_up(kl, bkv)
        pd = round_up(d, lane)
        grid = (b * hq, pq // bq, pkv // bkv)
        vmem = attention_block_bytes(workload, hw, bq, bkv, pd)
        order = "qk_causal" if "causal" in workload.tags else "qk"
        params = KernelParams(op, dims, (b, hq, hkv, pq, pkv, pd), (bq, bkv),
                              grid, order, True, workload.dtype,
                              workload.out_dtype, vmem, True)
    else:
        raise ValueError(f"unknown op {op}")

    return apply_postprocessors(workload, hw, params, postprocessors)


def instruction_census(workload: Workload, params: KernelParams) -> dict:
    """Schedule-derived block-instruction counts — the analogue of the
    paper's QEMU vector-instruction census (Fig. 5/9): per grid step the
    kernel issues block loads, one MAC-group, and stores only where the
    schedule says so. The store *fraction* is the paper's headline metric
    (tuned schedules keep it <1%; store-heavy library schedules don't)."""
    if params.op in ("matmul", "qmatmul", "gemv"):
        if params.op == "gemv":
            gn, gk = params.grid
            gm = 1
        else:
            # concretize always emits (m, n, k)- or (n, m, k)-major grids;
            # accumulate only changes store behaviour, never the grid layout.
            a, b_, gk = params.grid
            gm, gn = (b_, a) if params.order == "nmk" else (a, b_)
        steps = gm * gn * gk
        loads = 2 * steps  # x-block + w-block per step
        macs = steps
        config = steps  # per-step grid/DMA setup (vsetvl analogue)
        if params.accumulate:
            stores = gm * gn
        else:
            stores = steps  # partial product written back every k step
            loads += steps - gm * gn  # partials re-read on revisit
    elif params.op == "vmacc":
        steps = params.grid[0] * params.grid[1]
        loads, macs, stores, config = 3 * steps, steps, steps, steps
    elif params.op == "attention":
        bh, gq, gkv = params.grid
        steps = bh * gq * gkv
        loads = 3 * steps  # q, k, v blocks (q stays resident per row)
        macs = 2 * steps  # qk^T and pv
        stores = bh * gq  # output tile written once at the last kv step
        config = steps
    else:
        raise ValueError(params.op)
    total = loads + stores + macs + config
    return {"loads": loads, "stores": stores, "macs": macs,
            "config": config, "total": total,
            "store_fraction": stores / max(total, 1)}


def hbm_traffic_bytes(workload: Workload, params: KernelParams) -> float:
    """Modelled HBM traffic for a concrete schedule (feeds the analytic
    runner and the cost-model features).

    For matmul with an (m, n, k) grid and VMEM accumulation, each x-block is
    re-read once per n-step and each w-block once per m-step; the output is
    written once. Without accumulation (the muRISCV-NN-style store-happy
    variant) partial outputs are written and re-read every k-step.
    """
    ib = dtype_bytes(workload.dtype)
    ob = dtype_bytes(workload.out_dtype)
    if params.op in ("matmul", "qmatmul"):
        pm, pn, pk = params.padded_dims
        bm, bn, bk = params.block
        x_reads = pm * pk * (pn // bn)
        w_reads = pk * pn * (pm // bm)
        if params.accumulate:
            out_traffic = ob * pm * pn
        else:
            out_traffic = (2 * 4 * pm * pn * (pk // bk - 1)) + ob * pm * pn
        return ib * (x_reads + w_reads) + out_traffic
    if params.op == "gemv":
        pn, pk = params.padded_dims
        bn, bk = params.block
        x_reads = pk * (pn // bn)
        w_reads = pn * pk
        if params.accumulate:
            out_traffic = ob * pn
        else:
            out_traffic = 2 * 4 * pn * (pk // bk - 1) + ob * pn
        return ib * (x_reads + w_reads) + out_traffic
    if params.op == "vmacc":
        pr, pc = params.padded_dims
        return (3 * ib + ob) * pr * pc
    if params.op == "attention":
        b, hq, hkv, pq, pkv, d = params.padded_dims
        bq, bkv = params.block
        q = b * hq * pq * d
        kv = 2 * b * hkv * pkv * d * (pq // bq)  # k/v re-read per q block
        o = b * hq * pq * d
        return ib * (q + kv) + ob * o
    raise ValueError(params.op)
