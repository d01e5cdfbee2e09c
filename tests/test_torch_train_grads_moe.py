"""The models' backward, moe family: the port's loss and every gradient
leaf against ``jax.value_and_grad`` of the reference's, at ``reduced()``
in f32 (rtol 1e-4 / atol 1e-5), under each ``remat`` policy. The MoE's
dispatch and combine differentiate under autograd to what the reference's
``custom_vjp`` pair writes by hand; a case at a capacity that drops
assignments holds the dropped tokens' zero gradient to it too."""

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

from _torch_train_grads import (check_gradients, configs,  # noqa: E402
                                reference)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import from_numpy_params  # noqa: E402

ARCHS = ["qwen2_moe_a2_7b", "moonshot_v1_16b_a3b"]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, remat):
    check_gradients(arch, remat)


def test_moe_gradients_match_reference_when_capacity_drops():
    """At capacity factor 0.5 and 48 tokens a row, routing drops about half
    the assignments (checked); the gradients still equal the reference's
    custom-VJP ones, under remat none and full."""
    overrides = dict(capacity_factor=0.5)
    weights, batch, _, _ = reference("qwen2_moe_a2_7b", 48, **overrides)
    _, cfg = configs("qwen2_moe_a2_7b", **overrides)
    params = from_numpy_params(cfg, weights, "cpu")
    with torch.no_grad():
        x = L.embed(torch.as_tensor(batch["tokens"][:, :-1]), params, cfg,
                    torch.float32)
        lp = T.layer_slice(params["layers"], 0)
        _, _, slot, cap = moe.route(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["router"], cfg)
    dropped = (slot == moe.padded_experts(cfg) * cap).float().mean()
    assert 0.2 < float(dropped) < 0.8, float(dropped)
    for remat in ("none", "full"):
        check_gradients("qwen2_moe_a2_7b", remat, 48, **overrides)
