"""Per-device cost analysis of a step as it runs (the counterpart of the
JAX package's ``launch/hlo_analysis.py``).

The reference reads the partitioned HLO text of a compiled step. Eager
PyTorch has no HLO: :func:`analyze` runs the step under one
``TorchDispatchMode`` and counts the aten ops as they dispatch. All
quantities are per device, as the reference's are on the partitioned
module:

- ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, fused attention), the reference's "2 *
  prod(out_shape) * prod(contracted dims) per dot op";
- ``bytes``: per op, output bytes plus operand bytes, view and metadata
  ops skipped as the reference skips ``bitcast``/``tuple``/``parameter``;
- ``collective_bytes``: per ``_c10d_functional`` (or ``c10d``)
  collective, its output bytes, two times that for all-reduce (ring send
  and receive); with ``collective_counts`` and ``collective_bytes_by_op``
  under the reference's HLO names;
- ``op_census`` in the reference's categories, and ``n_instructions``;
- ``memory``: the live bytes' high-water mark, from a live-storage
  counter in the mode (each storage an op returns counted from its first
  sight until it is freed).

Per device on a DTensor: the mode declines every op that has a DTensor
argument (it returns ``NotImplemented``), so DTensor dispatches the op
itself, and the ops DTensor then runs on the local shards (the local
``mm`` at the shard shapes, the collectives of each redistribution, the
data moves around them) reach the mode as plain-tensor ops. A
``FlopCounterMode`` counts the DTensor-level op at its global shapes;
this mode never counts that one. Ops on ``FakeTensor``s (DTensor's
sharding propagation runs the op on them to learn its output's shape) are
not counted either.

The reference multiplies loop bodies by their trip counts (``lax.scan``
lowers to a ``while`` whose body XLA's cost analysis counts once). Eager
code runs every iteration of a Python loop, so each is counted as it runs
and nothing like the reference's ``trip_count`` is needed.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# aten op names by the reference's categories (the instruction-census
# analogue); anything else is "compute"
_CATEGORY = {
    "load": ("clone", "_to_copy", "contiguous", "gather", "index",
             "index_select", "embedding", "slice", "select", "narrow"),
    "store": ("copy_", "copy", "scatter", "scatter_", "scatter_add",
              "scatter_add_", "index_put", "index_put_", "index_add",
              "index_add_", "slice_scatter", "select_scatter",
              "masked_scatter", "embedding_dense_backward"),
    "layout": ("view", "_unsafe_view", "reshape", "transpose", "t",
               "permute", "expand", "cat", "stack", "constant_pad_nd",
               "unsqueeze", "squeeze", "flatten", "split", "split_with_sizes",
               "chunk", "unbind", "as_strided", "alias", "repeat",
               "repeat_interleave", "movedim", "unflatten"),
    "control": ("empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided", "zeros", "zeros_like", "new_zeros",
                "ones", "ones_like", "full", "full_like", "new_full",
                "arange", "scalar_tensor", "lift_fresh", "detach",
                "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
                "sym_size", "sym_stride", "sym_numel", "is_same_size"),
}
_OP2CAT = {op: cat for cat, ops in _CATEGORY.items() for op in ops}

# collectives by the reference's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "permute_tensor": "collective-permute",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "c10d_functional", "_dtensor")

# no data moves: the reference's bitcast/tuple/parameter/after-all
_SKIP_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "_unsafe_view",
               "_reshape_alias",
               "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
               "sym_size", "sym_stride", "sym_numel", "is_same_size"}


def shape_bytes(x) -> int:
    """Bytes of a tensor's elements, or the sum over tensors in a tuple or
    list (the reference's bytes of an HLO type string)."""
    if isinstance(x, (tuple, list)):
        return sum(shape_bytes(t) for t in x)
    if not torch.is_tensor(x):
        return 0
    return x.numel() * x.element_size()


def shape_dims(x) -> list[int]:
    """A tensor's dims (the first tensor's in a tuple or list)."""
    if isinstance(x, (tuple, list)):
        return shape_dims(x[0]) if x else []
    return list(x.shape) if torch.is_tensor(x) else []


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_bytes_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    op_census: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    n_instructions: float = 0.0
    # the live-storage counter's per-device bytes (``analyze``'s docstring)
    memory: dict = dataclasses.field(default_factory=dict)

    def to_json(self):
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_by_op": dict(self.collective_bytes_by_op),
            "op_census": dict(self.op_census),
            "n_instructions": self.n_instructions,
        }


def _local_tensors(tree) -> list:
    """The plain tensors of a pytree (modules' parameters, dicts, lists),
    each DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    from torch import nn

    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, nn.Module):
            out.extend(_local_tensors(list(leaf.parameters())))
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif torch.is_tensor(leaf):
            out.append(leaf)
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors, DTensors
    by their local shards: what one device holds of it."""
    seen = {}
    for t in _local_tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


class _CostMode(TorchDispatchMode):
    def __init__(self, summary: CostSummary, known: set):
        super().__init__()
        self.s = summary
        self.known = known  # the storages of the arguments (by _cdata)
        self.live = self.peak = 0
        self.by_storage: dict[int, int] = {}

    def _freed(self, key: int) -> None:
        self.live -= self.by_storage.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not torch.is_tensor(t):
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self.known or key in self.by_storage:
                continue
            n = s.nbytes()
            self.by_storage[key] = n
            self.live += n
            weakref.finalize(s, self._freed, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented  # DTensor runs it; its local ops come back
        out = func(*args, **kwargs)
        outs = tree_leaves(out)
        if any(isinstance(a, FakeTensor) for a in flat + outs):
            return out  # sharding propagation's shape inference
        s = self.s
        name = func.overloadpacket.__name__
        out_bytes = shape_bytes([t for t in outs if torch.is_tensor(t)])
        s.n_instructions += 1
        if func.namespace in _COLLECTIVE_NS and name in _COLLECTIVES:
            hlo = _COLLECTIVES[name]
            s.op_census["collective"] += 1
            b = out_bytes * (2.0 if hlo == "all-reduce" else 1.0)
            s.collective_bytes += b
            s.collective_counts[hlo] += 1
            s.collective_bytes_by_op[hlo] += b
        else:
            s.op_census[_OP2CAT.get(name, "compute")] += 1
        if func.overloadpacket in flop_registry:
            s.flops += flop_registry[func.overloadpacket](*args, **kwargs,
                                                          out_val=out)
        if not func.is_view and name not in _SKIP_BYTES:
            s.bytes += out_bytes + shape_bytes(
                [t for t in flat if torch.is_tensor(t)])
        self._track(out)
        return out


def analyze(fn, *args) -> CostSummary:
    """Run ``fn(*args)`` under the counting mode and return its per-device
    :class:`CostSummary`. Its ``memory`` holds, per device: the bytes of
    the arguments' storages (``argument_bytes``) and of the result's
    (``output_bytes``), the result's bytes that are arguments' storages
    (``alias_bytes``: a step that updates its state in place), the live
    bytes' high-water mark of what the call allocated, its outputs among
    them while alive (``temp_bytes``), and ``peak_estimate_bytes``, the
    arguments plus that mark."""
    summary = CostSummary()
    known = {t.untyped_storage()._cdata for t in _local_tensors(args)}
    mode = _CostMode(summary, known)
    with mode:
        out = fn(*args)
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _local_tensors(out)}
    arg_bytes = storage_bytes(args)
    summary.memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": sum(outs.values()),
        "alias_bytes": sum(n for k, n in outs.items() if k in known),
        "temp_bytes": mode.peak,
        "peak_estimate_bytes": arg_bytes + mode.peak,
    }
    return summary
