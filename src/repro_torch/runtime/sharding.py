"""Sharding rules: the logical parameter layout on a device mesh (the JAX
package's ``runtime/sharding.py``, ported to ``DeviceMesh`` and DTensor).

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod. The layout is FSDP x TP (MaxText-style):

- weights:   d_model dim sharded over ``data`` (FSDP: ZeRO-3 gathers are
  DTensor all-gathers), head/ffn/vocab dim over ``model`` (TP);
- MoE expert stacks: expert dim over ``model`` (EP);
- batch dims of activations over ``("pod", "data")``;
- the ``pod`` axis only carries data parallelism: cross-pod traffic is the
  gradient all-reduce, which is what the compression path targets.

An axis is applied to a dim only when the dim is divisible by (and at least
as large as) the axis size, else that dim stays replicated: the documented
fallbacks (e.g. kv-head counts below 16). Vocab dims are padded to 128 at
the embedding layer so they always divide.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, ``None`` (replicated), an axis name or a tuple of axis names
(one name stands alone, as ``PartitionSpec`` normalizes it), trailing
``None``s dropped. A mesh is a ``DeviceMesh`` with dim names or an
:func:`abstract_mesh`, which carries only the axis sizes: the rules need no
process group. :class:`NamedSharding` turns a spec into DTensor placements,
one ``Shard(dim)`` or ``Replicate()`` per mesh dim; a tensor dim over two
axes is two ``Shard(dim)`` in mesh-dim order, the outer axis first, as
JAX's major-to-minor order has it.

Paths are a parameter tree's keys joined with ``/`` (``layers/attn/wq``):
a model's ``named_parameters`` split on dots.
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.optim.tree import param_tree


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]):
    """The reference's ``AbstractMesh(axis_sizes, axis_names)``."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an abstract mesh, in
    mesh-dim order (the reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# Ordered (path-regex, spec-template) rules. Templates name mesh axes per
# dim; "_" = replicated. Matched against "/".join(path keys).
_RULES: list[tuple[str, tuple]] = [
    # embeddings
    (r"embedding$",              ("model", "data")),
    (r"lm_head$",                ("data", "model")),
    (r"(enc_pos|dec_pos)$",      ("_", "data")),
    # attention projections (stacked: leading layer dim)
    (r"attn/wq$",                ("_", "data", "model")),
    (r"attn/wk$",                ("_", "data", "model")),
    (r"attn/wv$",                ("_", "data", "model")),
    (r"attn/wo$",                ("_", "model", "data")),
    # dense mlp
    (r"mlp/w_(gate|up)$",        ("_", "data", "model")),
    (r"mlp/w_down$",             ("_", "model", "data")),
    # shared-expert mlp
    (r"shared/w_(gate|up)$",     ("_", "data", "model")),
    (r"shared/w_down$",          ("_", "model", "data")),
    # MoE expert stacks: (L, E, D, F) — EP over model
    (r"experts/w_(gate|up)$",    ("_", "model", "data", "_")),
    (r"experts/w_down$",         ("_", "model", "_", "data")),
    (r"router$",                 ("_", "data", "_")),
    # ssm
    (r"in_proj$",                ("_", "data", "model")),
    (r"out_proj$",               ("_", "model", "data")),
    (r"conv_w$",                 ("_", "_", "model")),
    # griffin recurrent blocks
    (r"w_[xy]$",                 ("_", "data", "model")),
    (r"w_[ai]$",                 ("_", "data", "model")),
    (r"w_out$",                  ("_", "model", "data")),
    # fallback: replicate
    (r".*",                      ()),
]


def spec_for(path_str: str, shape: tuple[int, ...], mesh) -> tuple:
    sizes = axis_sizes(mesh)
    for pattern, template in _RULES:
        if re.search(pattern, path_str):
            axes = []
            # align template to the trailing dims (stacked leading dims may
            # be absent in unstacked params)
            tpl = template[-len(shape):] if template else ()
            tpl = ("_",) * (len(shape) - len(tpl)) + tuple(tpl)
            for dim, ax in zip(shape, tpl):
                if ax == "_" or ax not in sizes:
                    axes.append(None)
                elif dim % sizes[ax] == 0 and dim >= sizes[ax]:
                    axes.append(ax)
                else:
                    # DTensor shards unevenly, but the reference's pjit
                    # needs even sharding: dims that don't divide (small
                    # kv-head counts etc.) stay replicated.
                    axes.append(None)
            # drop trailing Nones for a tidy spec
            while axes and axes[-1] is None:
                axes.pop()
            return tuple(axes)
    return ()


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    order, ``Shard(d)`` for the tensor dim ``d`` its axis names, else
    ``Replicate()``. A mesh dim of size 1 holds the whole tensor either
    way and is ``Replicate()``: DTensor then plans no redistribution over
    it (its planner takes seconds a new op on Shard placements)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, entry in enumerate(spec) if name in _entry_axes(entry)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def canonical(spec) -> tuple:
    """``spec`` as the reference's ``PartitionSpec`` holds it: a tuple of
    one axis name is the name, an empty one ``None``."""
    return tuple(None if entry == () else
                 entry[0] if isinstance(entry, tuple) and len(entry) == 1
                 else entry for entry in spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)``: a spec (made
    :func:`canonical`) on a mesh."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec", canonical(self.spec))

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, tensor):
        """``tensor`` (the same full value on every rank) as a DTensor laid
        out by this sharding; each rank keeps its own shard, no data moves
        between ranks."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor.detach(), self.mesh, self.placements,
                                 src_data_rank=None)


def _tree_map_with_path(fn, tree, prefix: tuple = ()):
    """A nested dict of ``fn("a/b", leaf)`` over a module's parameters or a
    nested dict of tensors."""
    tree = param_tree(tree)
    if not isinstance(tree, dict):
        return fn("/".join(prefix), tree)
    return {key: _tree_map_with_path(fn, value, prefix + (str(key),))
            for key, value in tree.items()}


def param_shardings(params, mesh, fsdp: bool = True):
    """Nested dict of NamedShardings matching ``params``' tree.

    ``fsdp=False`` drops the data-axis (ZeRO) sharding — weights are
    TP-sharded only and replicated across data. The serving layout: at
    batch-bound decode the per-step FSDP weight gathers dominate the
    collective term, while TP-only weights fit comfortably in bf16."""
    def leaf(path, x):
        spec = spec_for(path, tuple(x.shape), mesh)
        if not fsdp:
            spec = tuple(None if a == "data" else a for a in spec)
        return NamedSharding(mesh, spec)
    return _tree_map_with_path(leaf, params)


def param_specs(params, mesh):
    return _tree_map_with_path(
        lambda path, x: spec_for(path, tuple(x.shape), mesh), params)


# ------------------------------------------------------------- activations --

def batch_axes(mesh):
    """The data-parallel mesh axes (pod extends data when present)."""
    return (("pod", "data") if "pod" in axis_sizes(mesh) else ("data",))


def batch_spec(mesh) -> tuple:
    return canonical((batch_axes(mesh),))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def token_sharding(mesh, ndim: int = 2,
                   batch_size: int | None = None) -> NamedSharding:
    """(B, S[, ...]) activations: batch over the DP axes. If ``batch_size``
    is given and doesn't divide the DP degree (long_500k's batch of 1), the
    input stays replicated."""
    dp = batch_axes(mesh)
    if batch_size is not None:
        dp_size = _dp_size(mesh)
        if batch_size % dp_size or batch_size < dp_size:
            return NamedSharding(mesh, ())
    return NamedSharding(mesh, (dp, *([None] * (ndim - 1))))


def logits_sharding(mesh, ndim: int, batch_size: int,
                    vocab: int) -> NamedSharding:
    """(B, [S,] V) logits: batch over DP, padded vocab over model."""
    dp = batch_axes(mesh)
    dp_size = _dp_size(mesh)
    model = axis_sizes(mesh).get("model", 1)
    axes: list = [None] * ndim
    if batch_size % dp_size == 0 and batch_size >= dp_size:
        axes[0] = dp
    if vocab % model == 0 and vocab >= model:
        axes[-1] = "model"
    return NamedSharding(mesh, tuple(axes))


def cache_sharding(mesh, cache_shape: tuple[int, ...],
                   kv_heads_axis: int = 3,
                   prefer: str = "seq") -> NamedSharding:
    """KV-cache (L, B, T, H_kv, hd): batch over data; the model axis takes
    either the time dim (``prefer='seq'`` — context-parallel cache, default:
    per-device residency T/model, per-layer gathers) or the kv-heads dim
    (``prefer='heads'`` — zero attention collectives but full-T residency);
    whichever the preferred dim doesn't divide falls back to the other."""
    dp = batch_axes(mesh)
    model = axis_sizes(mesh).get("model", 1)
    axes: list = [None] * len(cache_shape)
    b = cache_shape[1]
    dp_size = _dp_size(mesh)
    if b % dp_size == 0 and b >= dp_size:
        axes[1] = dp
    if len(cache_shape) > kv_heads_axis:
        h = cache_shape[kv_heads_axis]
        t = cache_shape[2]
        t_ok = t % model == 0 and t >= model
        h_ok = h % model == 0 and h >= model
        if prefer == "heads" and h_ok:
            axes[kv_heads_axis] = "model"
        elif t_ok:
            axes[2] = "model"
        elif h_ok:
            axes[kv_heads_axis] = "model"
    while axes and axes[-1] is None:
        axes.pop()
    return NamedSharding(mesh, tuple(axes))


def cache_shardings(cache, mesh, prefer: str = "seq"):
    """Shardings for a cache tree (decode/serve path)."""
    def leaf(name, x):
        shape = tuple(x.shape)
        if name.split("/")[-1] in ("k", "v", "ck", "cv"):
            return cache_sharding(mesh, shape, prefer=prefer)
        # recurrent states: (L, B, ...) — batch over data, last dim model
        axes: list = [None] * len(shape)
        dp = batch_axes(mesh)
        dp_size = _dp_size(mesh)
        if len(shape) >= 2 and shape[1] % dp_size == 0 \
                and shape[1] >= dp_size:
            axes[1] = dp
        model = axis_sizes(mesh).get("model", 1)
        if len(shape) >= 3 and shape[-1] % model == 0 and shape[-1] >= model:
            axes[-1] = "model"
        return NamedSharding(mesh, tuple(axes))
    return _tree_map_with_path(leaf, cache)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
