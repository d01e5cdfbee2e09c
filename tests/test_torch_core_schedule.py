"""Unit + property tests for schedule traces, sampling, and the design space.

The JAX package's ``tests/test_core_schedule.py`` run against the PyTorch port
(``repro_torch``): its assertions, seeds and hypothesis properties unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (Schedule, TraceSampler, V5E, INTERPRET, concretize,
                              space_for)
from repro_torch.core import workload as W
from repro_torch.core.schedule import Decision


def test_schedule_roundtrip():
    s = Schedule.fixed(variant="mxu_256", m_scale=0.5, accumulate=True)
    j = s.to_json()
    s2 = Schedule.from_json(j)
    assert s == s2
    assert s2["variant"] == "mxu_256"
    assert s2.get("missing", 7) == 7
    with pytest.raises(KeyError):
        s2["missing"]


def test_schedule_replace_immutable():
    s = Schedule((Decision("a", 1, (1, 2, 3)),))
    s2 = s.replace("a", 2)
    assert s["a"] == 1 and s2["a"] == 2
    assert s2.decisions[0].candidates == (1, 2, 3)


def test_sampler_deterministic():
    wl = W.matmul(256, 512, 1024, "bfloat16")
    space = space_for(wl, V5E)
    a = TraceSampler(7).sample(space)
    b = TraceSampler(7).sample(space)
    assert a == b
    c = TraceSampler(8).sample(space)
    # different seed almost surely differs over this space
    assert a.names() == c.names()


def test_mutation_replays_program_coherently():
    """Mutation edits ≥1 site and re-executes the program: every decision in
    the child is drawn from the candidate set valid *given its upstream
    choices* (downstream sites may legitimately shift when a mutated variant
    changes their candidate sets)."""
    wl = W.matmul(256, 512, 1024)
    space = space_for(wl, V5E)
    s = TraceSampler(0).sample(space)
    sampler = TraceSampler(1)
    m = sampler.mutate(space, s, n_mutations=1)
    diffs = [n for n in s.names() if s[n] != m[n]]
    assert len(diffs) >= 1
    for d in m.decisions:
        assert d.choice in d.candidates
        assert d.candidates == space.candidates(d.name, m.as_dict())


def test_crossover_mixes_parents():
    """Crossover aligns by decision name; inherited choices survive where
    still coherent, and anything invalidated by the mixed upstream choices
    is resampled from the refreshed candidate set (never silently kept)."""
    wl = W.matmul(256, 512, 1024)
    space = space_for(wl, V5E)
    smp = TraceSampler(3)
    a, b = smp.sample(space), smp.sample(space)
    child = smp.crossover(space, a, b)
    assert child["variant"] in (a["variant"], b["variant"])
    for d in child.decisions:
        assert d.choice in d.candidates
        if d.choice not in (a.get(d.name), b.get(d.name)):
            # only resampled because the inherited choice stopped being
            # legal under the mixed upstream decisions
            assert (a.get(d.name) not in d.candidates
                    or b.get(d.name) not in d.candidates)


@settings(max_examples=30, deadline=None)
@given(
    m=st.integers(1, 2048), n=st.integers(1, 2048), k=st.integers(1, 2048),
    dtype=st.sampled_from(["float32", "bfloat16", "int8"]),
    seed=st.integers(0, 1000),
)
def test_concretize_always_legal(m, n, k, dtype, seed):
    """Every sampled trace concretizes to hardware-legal params (alignment,
    grid covers the padded shape) or is explicitly flagged invalid."""
    wl = W.Workload("matmul", (m, n, k), dtype)
    space = space_for(wl, V5E)
    s = TraceSampler(seed).sample(space)
    p = concretize(wl, V5E, s)
    bm, bn, bk = p.block
    pm, pn, pk = p.padded_dims
    assert pm % bm == 0 and pn % bn == 0 and pk % bk == 0
    assert pm >= m and pn >= n and pk >= k
    assert bn % V5E.lane_align(dtype) == 0
    if p.valid:
        assert p.vmem_bytes <= V5E.vmem_capacity * 0.9
        assert all(g >= 1 for g in p.grid)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 4096), k=st.integers(1, 4096),
       seed=st.integers(0, 100))
def test_gemv_space_property(n, k, seed):
    wl = W.gemv(n, k)
    space = space_for(wl, INTERPRET)
    s = TraceSampler(seed).sample(space)
    p = concretize(wl, INTERPRET, s)
    assert p.padded_dims[0] % p.block[0] == 0
    assert p.padded_dims[1] % p.block[1] == 0


def test_multi_granularity_registration():
    """The paper's VL-halving ladder: matching variants shrink with the
    workload (a VLMAX intrinsic must not match a small operator)."""
    from repro_torch.core import intrinsics
    big = intrinsics.variants_for(W.matmul(4096, 4096, 4096, "bfloat16"), V5E)
    small = intrinsics.variants_for(W.matmul(16, 16, 16, "bfloat16"), V5E)
    assert len(big) > len(small)
    big_blocks = {v.block for v in big}
    assert (8, 128, 128) in {v.block for v in small} or len(small) >= 1
    # ladder is halving: consecutive square variants differ by 2x
    sizes = sorted({v.block[0] for v in big if v.name.startswith("mxu_")},
                   reverse=True)
    for a, b in zip(sizes, sizes[1:]):
        if b >= 128:
            assert a == 2 * b
    assert big_blocks  # non-empty


def test_workload_key_stable():
    a = W.matmul(64, 64, 64, "float32")
    b = W.matmul(64, 64, 64, "float32")
    c = W.matmul(64, 64, 128, "float32")
    assert a.key() == b.key() != c.key()
    rt = W.Workload.from_json(a.to_json())
    assert rt.key() == a.key()


def test_workload_costs():
    wl = W.matmul(128, 256, 512, "bfloat16")
    assert wl.flops() == 2 * 128 * 256 * 512
    assert wl.min_bytes() == 2 * (128 * 512 + 512 * 256) + 2 * 128 * 256
    assert wl.arithmetic_intensity() > 1
