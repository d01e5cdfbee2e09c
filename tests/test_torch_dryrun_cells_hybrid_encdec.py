"""The port's dry run traces cells of the hybrid and the
encoder-decoder families at ``reduced()`` on the fake 16x16 mesh
(``tests/_torch_dryrun_cells.py``)."""

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

from _torch_dryrun_cells import (check_cells_trace,  # noqa: E402
                                 no_group_left)  # noqa: F401


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_tiny"])
def test_cells_trace_on_the_production_mesh(arch, monkeypatch):
    """A train, a prefill and a decode cell at reduced() on the fake 16x16
    mesh: each traces, counts its per-device work and gathers."""
    check_cells_trace(arch, monkeypatch)
