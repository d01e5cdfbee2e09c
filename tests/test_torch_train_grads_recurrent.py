"""The models' backward, ssm, hybrid and encdec families (Mamba2's SSD
scan, RecurrentGemma's RG-LRU scan and units, Whisper's encoder and
cross-attention): the port's loss and every gradient leaf against
``jax.value_and_grad`` of the reference's, at ``reduced()`` in f32 (rtol
1e-4 / atol 1e-5), under each ``remat`` policy."""

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

from _torch_train_grads import check_gradients  # noqa: E402

ARCHS = ["mamba2_780m", "recurrentgemma_2b", "whisper_tiny"]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, remat):
    check_gradients(arch, remat)
