"""Probabilistic sampling, mutation, and crossover of schedule traces.

This is the probabilistic-program part of the search: a schedule is the
recorded trace of a :class:`~repro_torch.core.space.SpaceProgram` execution, and
every draw flows through the program's **learned proposal distributions**
(:class:`~repro_torch.core.space.DecisionDistribution`). Fresh samples and
replayed resamples draw from each decision's posterior; mutation picks an
alternative for the perturbed site by posterior weight rather than
uniformly, so once measurements have trained the proposals the search
spends its perturbations where fast schedules live. With no evidence every
one of those draws degrades to the exact uniform index draw of the
pre-learned sampler (same ``rng.integers`` stream — the determinism
contract the tests pin).

Mutation and crossover never edit traces in place — they pin an edited set
of decisions and *replay the program*, so decisions downstream of an edit
see refreshed candidate sets (change the intrinsic variant and the tile
splits re-derive from its base block) and the child trace is coherent by
construction. This replaces the old independent-site resampling, whose
latent assumption — that every trace shares one decision layout — breaks as
soon as cross-hardware warm-start records or dynamic candidate sets enter
the population.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.core.space import SpaceProgram


def _as_program(space) -> SpaceProgram:
    if isinstance(space, SpaceProgram):
        return space
    if isinstance(space, Mapping):  # legacy flat dict space
        return SpaceProgram.from_flat(space)
    raise TypeError(f"not a design space: {type(space)!r}")


class TraceSampler:
    """Draws and perturbs schedule traces of a design-space program."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, space) -> Schedule:
        """Execute the program, drawing every decision fresh."""
        return _as_program(space).sample(self.rng)

    def mutate(self, space, schedule: Schedule,
               n_mutations: int = 1) -> Schedule:
        """Resample up to ``n_mutations`` decision sites, then replay the
        program downstream so dependent candidate sets refresh (a mutated
        variant re-derives the tile-split sets; pinned downstream choices
        survive only if still legal)."""
        program = _as_program(space)
        sites = [d for d in schedule.decisions if len(d.candidates) > 1]
        if not sites:
            return program.adopt(schedule, self.rng)
        n = min(n_mutations, len(sites))
        picked = self.rng.choice(len(sites), size=n, replace=False)
        pinned = schedule.as_dict()
        for i in picked:
            d = sites[int(i)]
            alternatives = tuple(c for c in d.candidates if c != d.choice)
            dist = program.dist(d.name)
            if dist is not None:
                # posterior-weighted alternative; no evidence -> the same
                # uniform rng.integers draw as before (bit-identical)
                pinned[d.name] = dist.draw(alternatives, self.rng)
            else:  # legacy-layout site the program doesn't know (e.g. m_scale)
                pinned[d.name] = alternatives[
                    int(self.rng.integers(len(alternatives)))]
        # legacy=pinned: a mutated v1-layout decision (e.g. m_scale) still
        # flows through the translation hooks instead of being dropped.
        return program.replay(pinned, self.rng, legacy=pinned)

    def crossover(self, space, a: Schedule, b: Schedule) -> Schedule:
        """Uniform crossover *aligned by decision name*, replay-validated.

        The two parents need not share a decision layout (cross-hardware
        warm-start traces, v1 records mixed with program traces): each named
        decision present in either parent is drawn from one of them, then
        the program is replayed so incoherent inheritances are resampled
        rather than silently mispaired."""
        program = _as_program(space)
        da, db = a.as_dict(), b.as_dict()
        pinned = {}
        for name in dict.fromkeys((*da, *db)):  # stable union order
            if name in da and name in db:
                pinned[name] = da[name] if self.rng.random() < 0.5 else db[name]
            elif self.rng.random() < 0.5:
                # a decision only one parent carries is still a coin flip:
                # when it loses, the other parent's legacy-layout decisions
                # (kept in the pinned/legacy dict under their own names) get
                # their shot through the translation hooks on replay
                pinned[name] = da.get(name, db.get(name))
        return program.replay(pinned, self.rng, legacy=pinned)
