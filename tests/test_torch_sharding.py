"""The port's sharding rules against the JAX package's, with no process
group (the rules read only a mesh's axis names and sizes):

- the three rule cases of the reference's test_sharding_and_analysis.py
  with their assertions;
- every architecture at full width on both production meshes (16x16 and
  2x16x16): the port's ``param_specs`` on its parameter shapes (built on
  the meta device) equal the reference's ``param_specs`` on
  ``jax.eval_shape`` of its init, leaf by leaf; the same for
  ``param_shardings(fsdp=False)`` and for ``cache_shardings`` of every
  decode cell (``decode_32k``, and ``long_500k`` where ``cells`` has it)
  with ``prefer`` "seq" and "heads";
- specs to DTensor placements, and the activation-sharding hooks as
  no-ops when unset or on plain tensors.
"""

import functools
import time

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models.model_zoo import build as ref_build  # noqa: E402
from repro.runtime import sharding as ref_sh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import ARCH_IDS, EXTRA_IDS, SHAPES, cells, \
    get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime.sharding import abstract_mesh  # noqa: E402

MESH = abstract_mesh((16, 16), ("data", "model"))
POD_MESH = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ------------------------------------------- the reference's rule cases ----

def test_param_rules():
    # embedding (padded vocab): vocab over model, d over data (FSDP)
    assert sh.spec_for("embedding", (49280, 2048), MESH) == ("model", "data")
    # attention projections: FSDP on d_model, TP on heads
    assert sh.spec_for("layers/attn/wq", (40, 2048, 2048), MESH) == \
        (None, "data", "model")
    assert sh.spec_for("layers/attn/wo", (40, 2048, 2048), MESH) == \
        (None, "model", "data")
    # kv projection with 8 heads * 64 = 512 still divides both axes
    assert sh.spec_for("layers/attn/wk", (40, 2048, 512), MESH) == \
        (None, "data", "model")
    # MoE experts: EP over model
    assert sh.spec_for("layers/experts/w_gate", (24, 64, 2048, 1408),
                       MESH) == (None, "model", "data")
    # small/non-divisible dims replicate (divisibility fallback)
    assert sh.spec_for("layers/ln1", (40, 2048), MESH) == ()
    assert sh.spec_for("layers/attn/wk", (2, 24, 24), MESH) == ()


def test_pod_axis_only_extends_batch():
    assert sh.batch_axes(POD_MESH) == ("pod", "data")
    assert sh.batch_axes(MESH) == ("data",)
    # params never shard over 'pod' (pure DP across pods)
    spec = sh.spec_for("layers/mlp/w_up", (40, 2048, 8192), POD_MESH)
    assert "pod" not in spec


def test_cache_rules():
    # default: context-parallel (sequence-sharded) cache
    # (a tuple of one axis is the axis, as PartitionSpec normalizes it)
    s = sh.cache_sharding(MESH, (24, 128, 32768, 16, 128))
    assert s.spec == sh.canonical((None, ("data",), "model")) == \
        (None, "data", "model")
    # heads preference when requested and divisible
    s = sh.cache_sharding(MESH, (24, 128, 32768, 16, 128), prefer="heads")
    assert s.spec == sh.canonical((None, ("data",), None, "model"))
    # tiny batch, single kv head: sequence sharding is the only option
    s = sh.cache_sharding(MESH, (26, 1, 524288, 1, 256))
    assert s.spec == (None, None, "model")


# ------------------------------ every architecture at full width, parity ----

class _MetaGenerator(torch.Generator):
    """A generator whose tensors the port's init draws on the meta device:
    full-width shapes without their memory."""

    @property
    def device(self):
        return torch.device("meta")


@functools.lru_cache(maxsize=None)
def _port_bundle(arch):
    return build(get_config(arch), device="meta")


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return _port_bundle(arch).init(_MetaGenerator())


@functools.lru_cache(maxsize=None)
def _ref_bundle(arch):
    return ref_build(ref_configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(_ref_bundle(arch).init, jax.random.key(0))


def _flat_port(tree, prefix=()):
    if not isinstance(tree, dict):
        return {"/".join(prefix): tree}
    out = {}
    for key, value in tree.items():
        out.update(_flat_port(value, prefix + (str(key),)))
    return out


def _flat_ref(tree):
    """{"a/b": leaf} of a reference tree whose leaves are PartitionSpecs
    or NamedShardings (their specs)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_sh._path_str(path): getattr(leaf, "spec", leaf)
            for path, leaf in leaves}


def _assert_same_specs(ours, theirs, what):
    ours, theirs = _flat_port(ours), _flat_ref(theirs)
    assert ours.keys() == theirs.keys(), what
    for name, spec in ours.items():
        spec = getattr(spec, "spec", spec)
        assert spec == tuple(theirs[name]), (what, name, spec, theirs[name])


ALL_IDS = ARCH_IDS + EXTRA_IDS


# Full-width shapes on the meta device take well under a second a config;
# drawn for real they would take minutes and tens of GB.
DEADLINE_S = 10.0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_specs_match_reference(arch, mesh):
    """``param_specs`` and ``param_shardings(fsdp=False)`` of the
    unreduced config, leaf by leaf, the port's shapes built within
    DEADLINE_S."""
    ours_mesh, theirs_mesh = abstract_mesh(*MESHES[mesh]), \
        ref_sh.abstract_mesh(*MESHES[mesh])
    t0 = time.perf_counter()
    params = _port_params(arch)
    assert time.perf_counter() - t0 < DEADLINE_S
    ref_params = _ref_params(arch)
    _assert_same_specs(sh.param_specs(params, ours_mesh),
                       ref_sh.param_specs(ref_params, theirs_mesh),
                       f"{arch} {mesh} param_specs")
    _assert_same_specs(
        sh.param_shardings(params, ours_mesh, fsdp=False),
        ref_sh.param_shardings(ref_params, theirs_mesh, fsdp=False),
        f"{arch} {mesh} fsdp=False")


DECODE_CELLS = [(arch, cell) for arch in ALL_IDS
                for cell in ("decode_32k", "long_500k")
                if cell in ref_configs.cells(arch)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,cell", DECODE_CELLS)
def test_cache_shardings_match_reference(arch, cell, mesh):
    """``cache_shardings`` of the decode cache at the cell's batch and
    length, ``prefer`` "seq" and "heads", leaf by leaf."""
    shape = SHAPES[cell]
    ours_mesh, theirs_mesh = abstract_mesh(*MESHES[mesh]), \
        ref_sh.abstract_mesh(*MESHES[mesh])
    cache = _port_bundle(arch).init_cache(shape.global_batch, shape.seq_len)
    rb = _ref_bundle(arch)
    ref_cache = jax.eval_shape(
        lambda: rb.init_cache(shape.global_batch, shape.seq_len))
    for prefer in ("seq", "heads"):
        _assert_same_specs(
            sh.cache_shardings(cache, ours_mesh, prefer=prefer),
            ref_sh.cache_shardings(ref_cache, theirs_mesh, prefer=prefer),
            f"{arch} {cell} {mesh} prefer={prefer}")


def test_cells_are_the_reference_s():
    assert all(cells(a) == ref_configs.cells(a) for a in ARCH_IDS)


def test_activation_specs_match_reference():
    """``batch_spec``, ``token_sharding`` (batch that does and does not
    divide the DP degree), ``logits_sharding`` and ``replicated``."""
    for name, (sizes, axes) in MESHES.items():
        ours, theirs = abstract_mesh(sizes, axes), \
            ref_sh.abstract_mesh(sizes, axes)
        assert sh.batch_spec(ours) == tuple(ref_sh.batch_spec(theirs))
        assert sh.replicated(ours).spec == tuple(ref_sh.replicated(theirs)
                                                 .spec)
        for ndim, batch in ((2, None), (3, None), (2, 1), (2, 512)):
            assert sh.token_sharding(ours, ndim, batch).spec == tuple(
                ref_sh.token_sharding(theirs, ndim, batch).spec), \
                (name, ndim, batch)
        for ndim, batch, vocab in ((3, 32, 49280), (2, 1, 256000),
                                   (3, 512, 100)):
            assert sh.logits_sharding(ours, ndim, batch, vocab).spec == \
                tuple(ref_sh.logits_sharding(theirs, ndim, batch,
                                             vocab).spec), name


# -------------------------------------------------- placements and hooks ----

def test_specs_become_placements_in_mesh_order():
    mesh = abstract_mesh((2, 4), ("data", "model"))
    assert sh.placements(("model", "data"), mesh) == (Shard(1), Shard(0))
    assert sh.placements((None, "data", "model"), mesh) == (Shard(1),
                                                            Shard(2))
    assert sh.placements((), mesh) == (Replicate(), Replicate())
    assert sh.NamedSharding(mesh, (None, "model")).placements == \
        (Replicate(), Shard(1))
    # a dim over two axes: a Shard of it per axis, the outer axis first
    pod = abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), pod) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.token_sharding(pod, 2).placements == (Shard(0), Shard(0),
                                                    Replicate())
    # a mesh dim of size 1 holds the whole tensor: replicated
    host = abstract_mesh((1, 1), ("data", "model"))
    assert sh.placements((None, "data", "model"), host) == (Replicate(),
                                                            Replicate())
    with pytest.raises(ValueError, match="shards dims"):
        sh.placements(("model", "model"), mesh)


def test_hooks_are_no_ops_unset_and_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert L.shard_act(x) is x and L.shard_expert(x) is x
    L.set_activation_sharding(("data",), 2, "model", 2)
    try:
        assert L.shard_act(x, seq_model=True) is x
        assert L.shard_act(x, last_dim_model=True) is x
        assert L.shard_expert(x) is x
        assert L.by_rows(lambda t, k: (t * k, 3), x, 2)[1] == 3
    finally:
        L.clear_activation_sharding()
    assert L._BATCH_AXES is None and L._MODEL_AXIS is None
