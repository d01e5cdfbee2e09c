"""Schedules as probabilistic-program traces.

MetaSchedule represents a candidate as the trace of its sampled scheduling
decisions; mutation and replay operate on the trace, not on generated code.
A :class:`Schedule` is an ordered sequence of named :class:`Decision`\\ s,
each recording the chosen value, the candidate set it was drawn from *at the
moment it was sampled*, and its provenance (sampled fresh, pinned during a
replay, translated from a legacy trace, ...).

Two trace layouts coexist:

- **v1 (flat)** — independent decisions over a flat dict space
  (``m_scale``/``n_scale``/... categorical draws). These are what old
  database records and the hand-written :meth:`Schedule.fixed` library
  schedules contain. They serialize as a bare JSON list, byte-compatible
  with databases written before the generative-program refactor.
- **v2 (generative)** — traces produced by executing a
  :class:`~repro_torch.core.space.SpaceProgram`, where later decisions' candidate
  sets (``bm``/``bn``/``bk`` perfect-tile splits) depend on earlier choices
  (the intrinsic variant). They serialize as ``{"version": 2, "decisions":
  [...]}``.

Mutation and crossover do not edit v2 traces in place: they pin decisions
and *re-execute the program* (:meth:`SpaceProgram.replay`) so downstream
candidate sets refresh and the trace stays coherent. Equality and hashing
ignore version/provenance — two traces that make the same choices are the
same schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

# Decision provenance markers (informational; never part of identity).
PROV_SAMPLED = "sampled"    # drawn fresh from the candidate set
PROV_PINNED = "pinned"      # kept from the trace being replayed
PROV_LEGACY = "legacy"      # translated from a v1 (flat) trace decision
PROV_FIXED = "fixed"        # hand-written library choice, no search


@dataclasses.dataclass(frozen=True)
class Decision:
    name: str
    choice: Any
    candidates: tuple = ()
    provenance: str = ""

    def to_json(self):
        d = {"name": self.name, "choice": self.choice,
             "candidates": list(self.candidates)}
        if self.provenance:
            d["provenance"] = self.provenance
        return d

    @staticmethod
    def from_json(d):
        return Decision(d["name"], _detuple(d["choice"]),
                        tuple(_detuple(c) for c in d.get("candidates", [])),
                        d.get("provenance", ""))


def _detuple(x):
    # JSON round-trips tuples as lists; normalize back for hashing/eq.
    if isinstance(x, list):
        return tuple(_detuple(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An immutable trace of scheduling decisions.

    ``version`` records the trace layout (1 = flat independent decisions,
    2 = generative-program trace); it selects the JSON wire format but is
    never part of schedule identity.
    """

    decisions: tuple[Decision, ...]
    version: int = 1

    # ---- access -------------------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        for d in self.decisions:
            if d.name == name:
                return d.choice
        raise KeyError(name)

    def get(self, name: str, default: Any = None) -> Any:
        for d in self.decisions:
            if d.name == name:
                return d.choice
        return default

    def names(self) -> list[str]:
        return [d.name for d in self.decisions]

    def as_dict(self) -> dict[str, Any]:
        return {d.name: d.choice for d in self.decisions}

    # ---- functional updates --------------------------------------------------
    def replace(self, name: str, choice: Any) -> "Schedule":
        """Swap one decision's choice in place, *without* re-executing any
        program (dependent candidate sets are not refreshed — use
        ``SpaceProgram.replay`` / ``TraceSampler.mutate`` for coherent
        edits; this is the raw trace surgery tests and lowering use)."""
        out = []
        found = False
        for d in self.decisions:
            if d.name == name:
                out.append(Decision(name, choice, d.candidates, d.provenance))
                found = True
            else:
                out.append(d)
        if not found:
            raise KeyError(name)
        return Schedule(tuple(out), self.version)

    # ---- identity / io --------------------------------------------------------
    def signature(self) -> tuple:
        """The trace's content key: the ordered (name, choice) pairs,
        ignoring version, provenance, and candidate sets. This is the
        identity every dedup layer keys on — the tuner's in-flight sets,
        the database's record dedup and cross-session measured-latency
        memo, the batch dedup knobs on runners and the board farm, and
        (one concretization later, as ``KernelParams.signature()``) the
        build cache. Value-derived by construction — never ``id()`` or a
        default ``repr`` (``tools/lint_invariants.py`` enforces this for
        new cache keys in ``core/``)."""
        return tuple((d.name, d.choice) for d in self.decisions)

    def __hash__(self):
        return hash(self.signature())

    def __eq__(self, other):
        return isinstance(other, Schedule) and self.signature() == other.signature()

    def to_json(self):
        """v1 traces keep the original bare-list wire format (databases
        written before the program refactor stay byte-identical); v2 traces
        are versioned dicts."""
        items = [d.to_json() for d in self.decisions]
        if self.version <= 1:
            return items
        return {"version": self.version, "decisions": items}

    @staticmethod
    def from_json(payload) -> "Schedule":
        """Decode either wire format: a bare list (v1, pre-program records)
        or a ``{"version": ..., "decisions": [...]}`` dict (v2)."""
        if isinstance(payload, dict):
            return Schedule(
                tuple(Decision.from_json(d) for d in payload["decisions"]),
                version=int(payload.get("version", 2)))
        return Schedule(tuple(Decision.from_json(d) for d in payload),
                        version=1)

    @staticmethod
    def fixed(**choices: Any) -> "Schedule":
        """A hand-written / library schedule: singleton candidate sets, no
        search. Stays a v1 (flat-layout) trace — the legacy concretize path
        reads it directly and ``SpaceProgram.adopt`` translates it when one
        is used to seed a generative search."""
        return Schedule(tuple(Decision(k, v, (v,), PROV_FIXED)
                              for k, v in choices.items()))

    def __repr__(self):
        inner = ", ".join(f"{d.name}={d.choice}" for d in self.decisions)
        return f"Schedule({inner})"
