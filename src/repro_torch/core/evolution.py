"""Evolutionary search over schedule traces, guided by two learned models.

MetaSchedule's search: keep a population of traces, mutate/crossover via
trace replay on the design-space program, rank with the learned cost model,
measure the top predicted candidates, repeat. Two feedback loops steer it:
the **cost model** ranks candidates before measurement, and the program's
**learned proposal distributions** shape where candidates come from in the
first place — immigrants, the fresh-sample fill of :meth:`seed_population`,
and the `propose` fallback all draw through
``sampler.sample(self.space)``, and mutation picks alternatives by
posterior weight, so once the tuner has fed measured rewards back into the
program (:meth:`SpaceProgram.observe`) every generation is biased toward
decisions that produced fast schedules. Measured warm-start schedules —
including v1 flat records from the database — are *adopted* onto the
program (replayed with legacy translation) before they seed the population,
so every population member shares the program's decision layout and
mutation/crossover stay coherent.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import RidgeCostModel, features
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.sampler import TraceSampler
from repro_torch.core.schedule import Schedule
from repro_torch.core.space import SpaceProgram
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class EvolutionarySearch:
    workload: Workload
    hw: HardwareConfig
    space: SpaceProgram
    sampler: TraceSampler
    population_size: int = 32
    mutation_rate: float = 0.6
    crossover_rate: float = 0.2
    immigrant_rate: float = 0.2  # fresh random traces per generation

    def __post_init__(self):
        self.population: list[Schedule] = []

    # -------------------------------------------------------------------------
    def _valid(self, s: Schedule) -> bool:
        return self.space.validate(s).valid

    def seed_population(self, measured: list[Schedule]) -> None:
        """Seed from measured traces, adopted onto the program (v1 records
        and foreign-hardware transfers translate through the legacy hooks),
        then fill with fresh samples."""
        pop: list[Schedule] = []
        seen: set[tuple] = set()
        for s in measured:
            t = self.space.adopt(s, self.sampler.rng)
            sig = t.signature()
            if sig not in seen and self._valid(t):
                seen.add(sig)
                pop.append(t)
        tries = 0
        while len(pop) < self.population_size and tries < 20 * self.population_size:
            s = self.sampler.sample(self.space)
            tries += 1
            if s.signature() not in seen and self._valid(s):
                seen.add(s.signature())
                pop.append(s)
        self.population = pop[: self.population_size]

    def evolve(self, cost_model: RidgeCostModel,
               elites: list[Schedule]) -> None:
        """One generation: elites + mutants + crossovers + immigrants,
        de-duplicated, ranked by the cost model."""
        rng = self.sampler.rng
        parents = elites + self.population
        children: list[Schedule] = list(elites)
        budget = 4 * self.population_size
        while len(children) < budget:
            r = rng.random()
            if r < self.immigrant_rate or not parents:
                cand = self.sampler.sample(self.space)
            elif r < self.immigrant_rate + self.crossover_rate and len(parents) >= 2:
                i, j = rng.choice(len(parents), size=2, replace=False)
                cand = self.sampler.crossover(self.space, parents[int(i)],
                                              parents[int(j)])
            else:
                p = parents[int(rng.integers(len(parents)))]
                cand = self.sampler.mutate(self.space, p,
                                           n_mutations=1 + int(rng.integers(2)))
            if self._valid(cand):
                children.append(cand)
        # de-dup, rank by predicted latency
        seen, uniq = set(), []
        for c in children:
            sig = c.signature()
            if sig not in seen:
                seen.add(sig)
                uniq.append(c)
        if cost_model.fitted:
            feats = [features(self.workload, self.hw, self.space.validate(c))
                     for c in uniq]
            order = cost_model.rank(feats)
            uniq = [uniq[int(i)] for i in order]
        self.population = uniq[: self.population_size]

    def propose(self, n: int, exclude: set) -> list[Schedule]:
        """Top-n unmeasured candidates (epsilon-greedy: a random tail slot)."""
        out = []
        for c in self.population:
            if c.signature() not in exclude:
                out.append(c)
            if len(out) >= n:
                break
        tries = 0
        while len(out) < n and tries < 50 * n:
            c = self.sampler.sample(self.space)
            tries += 1
            if c.signature() not in exclude and self._valid(c):
                out.append(c)
        return out
