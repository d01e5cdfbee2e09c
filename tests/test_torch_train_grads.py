"""The models' backward, dense and vlm families: the port's loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's, at
``reduced()`` in f32 (rtol 1e-4 / atol 1e-5), under each ``remat`` policy
(none, full, dots). Also what the policies and ``unbind_layers`` do to the
backward: "full" recomputes the layers' matmuls, "dots" keeps them and
recomputes the rest, and each stacked parameter is taken apart once
(one ``unbind``, no per-layer ``select``)."""

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_train_grads import check_gradients  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402

ARCHS = ["granite_3_2b", "gemma3_1b", "yi_6b", "h2o_danube_1_8b",
         "qwen2_vl_7b"]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, remat):
    check_gradients(arch, remat)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(remat):
    cfg = get_config("granite_3_2b").reduced()
    bundle = build(cfg, remat=remat, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    loss = bundle.loss_fn(params, bundle.make_batch(
        0, ShapeSpec("g", 16, 2, "train")))
    with _OpCount() as ops:
        torch.autograd.grad(loss, list(params.parameters()))
    return ops.counts, loss


def test_remat_policies_recompute_what_they_should():
    none, _ = _backward_ops("none")
    full, _ = _backward_ops("full")
    dots, _ = _backward_ops("dots")
    layers = get_config("granite_3_2b").reduced().n_layers
    # full: each layer's forward runs again, its 6 projections with it
    assert full["mm"] == none["mm"] + 6 * layers
    assert full["bmm"] > none["bmm"]
    # dots: the projections' outputs are kept, attention is recomputed
    assert dots["mm"] == none["mm"]
    assert dots["bmm"] > none["bmm"]
    with pytest.raises(ValueError, match="remat"):
        T.remat_layer(lambda x: x, "nothing")


def _graph(loss):
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return seen


def test_layer_slice_unbinds_each_stack_once():
    """Each stacked parameter feeds one UnbindBackward (whose backward is
    one stack); none feeds a per-layer select."""
    _, loss = _backward_ops("none")
    nodes = _graph(loss)
    feeds = {}
    for node in nodes:
        for nxt, _ in node.next_functions:
            if nxt is not None and type(nxt).__name__ == "AccumulateGrad":
                if nxt.variable.dim() >= 2 and nxt.variable.shape[0] == 2:
                    feeds.setdefault(id(nxt), []).append(
                        type(node).__name__)
    assert feeds, "no stacked parameter found"
    assert all(kinds == ["UnbindBackward0"] for kinds in feeds.values()), \
        feeds


def test_layer_views_follow_the_parameters():
    """``unbind_layers`` gives each layer what ``layer_slice`` gives it, as
    views of the stacks: an in-place update of a stack shows through them;
    made under grad they carry the unbind's backward, under no_grad none."""
    cfg = get_config("granite_3_2b").reduced()
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    stacks = params["layers"]
    with torch.no_grad():
        views = T.unbind_layers(stacks)
        assert len(views) == cfg.n_layers
        for i, view in enumerate(views):
            assert all(torch.equal(a, b) for a, b in zip(
                T.tree_tensors(view), T.tree_tensors(T.layer_slice(stacks, i)),
                strict=True))
        assert views[1]["attn"]["wq"].grad_fn is None
        stacks["attn"]["wq"].add_(1.0)
        assert torch.equal(views[1]["attn"]["wq"], stacks["attn"]["wq"][1])
    assert T.unbind_layers(stacks)[1]["attn"]["wq"].grad_fn is not None
