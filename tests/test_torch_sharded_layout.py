"""The sharded step laid out as the reference lays it out.

- ``layers._sdpa`` under autograd keeps no chunk's scores for the
  backward, which recomputes each chunk's scores and probabilities (the
  reference's ``jax.checkpoint(body, nothing_saveable)``), and its
  gradients equal ``jax.grad`` of the reference's ``_sdpa``.
- On the fake 16x16 group (the dry run's, ``tests/test_torch_dryrun.py``'s
  pattern) at ``reduced()``: attention splits its query heads or rows over
  "model" where 16 divides neither KV head count, so a device computes
  1/256 of the whole step's attention (1/16 of its batch shard's); MoE
  dispatch and combine run on each rank's rows, so no all-gather is the
  size of the (B, E x cap, D) slot buffer; Mamba2's ``in_proj`` outputs
  are products with the weight's columns, so none is gathered.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402
from torch.utils.flop_counter import flop_registry  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.moe import padded_experts  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

# a train cell of the reduced configs on the 16x16 mesh: the batch
# divides the data axis and the sequence the model axis
TRAIN = ShapeSpec("train_4k", 32, 32, "train")


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


# ------------------------------------------------------- chunk recompute --

def _saved_bytes(s, t, b=1, h=2, d=16):
    """Bytes autograd keeps for ``_sdpa``'s backward at B=1, H=2, D=16:
    what its saved-tensor hooks pack."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, h, d, generator=g, requires_grad=True)
               for n in (s, t, t))
    rows = torch.arange(s, dtype=torch.int32)
    cols = torch.arange(t, dtype=torch.int32)
    saved = [0]

    def pack(x):
        saved[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        L._sdpa(q, k, v, rows, cols)
    return saved[0]


def test_sdpa_keeps_no_chunk_scores_for_the_backward():
    """At S = T = 2048 (two 1024-key chunks) the saved bytes stay within
    a few copies of the (B, H, S, D) f32 output (the parent kept every
    chunk's (B, H, S, C) f32 scores and probabilities: 106.9 MB)."""
    b, h, s, d = 1, 2, 2048, 16
    state = b * h * s * d * 4
    got = _saved_bytes(s, s, b, h, d)
    assert got <= 8 * state, (got, state)
    assert got < b * h * s * L.ATTN_CHUNK * 4  # under one chunk's scores


# (S, T, query heads, KV heads, window, causal, rows' first position)
SDPA_CASES = {
    "gqa-causal": (40, 40, 4, 2, -1, True, 0),
    "window": (40, 40, 4, 4, 8, True, 0),
    "cross": (24, 40, 4, 1, -1, False, 0),
    "decode-row": (1, 40, 4, 2, -1, True, 39),
}


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_gradients_equal_the_reference(case, monkeypatch):
    """f32 gradients of a weighted sum of the output, with 16-key chunks
    (three, the last padded), against ``jax.grad`` of the reference's
    ``_sdpa`` at the same chunk: within 1e-5."""
    s, t, hq, hkv, window, causal, first = SDPA_CASES[case]
    monkeypatch.setattr(L, "ATTN_CHUNK", 16)
    monkeypatch.setattr(ref_layers, "ATTN_CHUNK", 16)
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, s, hq, 8), (2, t, hkv, 8), (2, t, hkv, 8)))
    w = rng.standard_normal((2, s, hq * 8)).astype(np.float32)
    rows = np.arange(first, first + s, dtype=np.int32)
    cols = np.arange(t, dtype=np.int32)

    def ref_loss(q, k, v):
        return jnp.sum(ref_layers._sdpa(q, k, v, jnp.asarray(rows),
                                        jnp.asarray(cols), window, causal)
                       * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = L._sdpa(qt, kt, vt, torch.tensor(rows), torch.tensor(cols),
                  window, causal)
    (out * torch.tensor(w)).sum().backward()
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{case} d{name}")


# ----------------------------------------------- the fake production mesh --

class _Ops(TorchDispatchMode):
    """Records each plain op a step runs on this rank (DTensor's local
    ops and collectives; a DTensor op itself is declined, sharding
    propagation's fake ops skipped): its name, flops and output shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        if any(isinstance(a, FakeTensor) for a in flat + outs):
            return out
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
        self.ops.append((func.overloadpacket.__name__, flops,
                         [tuple(t.shape) for t in outs],
                         sum(t.numel() * t.element_size() for t in outs)))
        return out


def _run_cell(arch, monkeypatch, n_ranks, cfg=None, shape=TRAIN):
    """The reduced ``arch``'s train cell (``shape``) on the fake 16x16
    group (``n_ranks`` 256) or a fake (1, 1) one (1), run once under
    :class:`_Ops` as ``dryrun.trace_step`` runs it."""
    cfg = cfg or get_config(arch).reduced()
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfg)
    monkeypatch.setitem(SHAPES, "train_4k", shape)
    with dryrun.fake_world(n_ranks):
        mesh = (make_production_mesh(device="cpu") if n_ranks > 1
                else make_host_mesh("cpu"))
        fn, args = dryrun.build_cell(arch, "train_4k", mesh)
        sizes = sh.axis_sizes(mesh)
        L.set_activation_sharding(sh.batch_axes(mesh), sizes["data"],
                                  "model", sizes["model"])
        rec = _Ops()
        try:
            with dryrun._card_collectives(), rec:
                fn(*args)
        finally:
            L.clear_activation_sharding()
    return rec.ops


def _gathers(ops):
    return [(shapes[0], n) for name, _, shapes, n in ops
            if name in ("all_gather_into_tensor", "_allgather_base_",
                        "allgather_")]


@pytest.mark.parametrize("heads", [(4, 2), (32, 8)], ids=["rows", "heads"])
def test_attention_splits_over_model(heads, monkeypatch):
    """Granite's train cell with query / KV heads 4 / 2 (16 divides
    neither: the query rows split) and 32 / 8 (its published counts: the
    query heads split, each rank reading its block's KV head): a device's
    attention products (the step's ``bmm``s: scores, PV and their
    backward) are 1/256 of the (1, 1) mesh's, 16 batch shards times 16
    model ranks. The parent replicated them over "model": 1/16."""
    cfg = dataclasses.replace(get_config("granite_3_2b").reduced(),
                              n_heads=heads[0], n_kv_heads=heads[1])
    bmm = {}
    for n in (1, 256):
        ops = _run_cell("granite_3_2b", monkeypatch, n, cfg)
        bmm[n] = sum(f for name, f, _, _ in ops if name == "bmm")
    assert bmm[1] > 0
    assert bmm[256] * 256 == bmm[1], (bmm, bmm[1] / bmm[256])


def test_moe_dispatch_gathers_no_slot_buffer(monkeypatch):
    """Qwen1.5-MoE's train cell: no all-gather is as large as the (B,
    E x cap, D) slot buffer (the parent's DTensor scatter gathered it
    whole over the batch shards); the largest left is the combine's
    gather of one batch shard's expert outputs over "model"."""
    cfg = get_config("qwen2_moe_a2_7b").reduced()
    e = padded_experts(cfg)
    cap = max(8, math.ceil(TRAIN.seq_len * cfg.top_k / e
                           * cfg.capacity_factor))
    buffer = TRAIN.global_batch * e * cap * cfg.d_model * 4
    gathers = _gathers(_run_cell("qwen2_moe_a2_7b", monkeypatch, 256))
    assert gathers
    assert max(n for _, n in gathers) <= buffer // 16, \
        (buffer, sorted(gathers, key=lambda g: -g[1])[:3])


def test_mamba2_gathers_no_in_proj_output(monkeypatch):
    """Mamba2's train cell, its heads 8 wide so that 16 divides
    ``in_proj``'s width (304) as it divides the published 6448, at seq 64
    so that a rank's 128 tokens outnumber the weight's 64 rows (as a
    published cell's 65536 outnumber 1536; with fewer, as in decode, the
    product is the smaller to gather): no all-gather of a (B, S, ...)
    activation as wide as ``in_proj``'s output or its z or x part (the
    parent sliced the model-sharded product five ways, each slice
    gathering it whole)."""
    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                              ssm_head_dim=8)
    shape = ShapeSpec("train_4k", 64, 32, "train")
    d_in = cfg.ssm_expand * cfg.d_model
    width = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
    b_local = shape.global_batch // 16
    assert width % 16 == 0 and b_local * shape.seq_len > cfg.d_model
    gathers = _gathers(_run_cell("mamba2_780m", monkeypatch, 256, cfg,
                                 shape))
    assert gathers
    # an all-gather's output stacks the shards along dim 0: (16 B, S,
    # w / 16) for a (B, S, w) activation sharded on w
    act = {b_local * shape.seq_len * w for w in (width, d_in)}
    wide = [s for s, _ in gathers if len(s) == 3
            and s[1] == shape.seq_len and math.prod(s) in act]
    assert not wide, wide
