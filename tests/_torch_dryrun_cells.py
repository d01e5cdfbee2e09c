"""The cell traces of the port's dry run, shared by the
``test_torch_dryrun_cells_*`` files (split by architecture so that
``--dist loadfile`` can spread them over the test processes): a train, a
prefill and a decode cell of one architecture at ``reduced()`` on the fake
16x16 mesh, ``SHAPES`` shrunk."""

import pytest
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun

# SHAPES shrunk for the reduced configs on the 16x16 mesh: each batch
# still divides the data axis (a microbatch of qwen2_vl's two too)
SMALL = {"train_4k": ShapeSpec("train_4k", 32, 32, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 32, 16, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 32, 16, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


def check_cells_trace(arch, monkeypatch):
    """A train, a prefill and a decode cell at reduced() on the fake 16x16
    mesh: each traces, counts its per-device work and gathers."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    for name, shape in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shape)
    for name in SMALL:
        rec = dryrun.run_cell(arch, name, multi_pod=False)
        assert rec["ok"], (name, rec.get("traceback"))
        a, mem = rec["analysis"], rec["memory"]
        assert a["flops"] > 0 and a["bytes"] > 0, name
        assert a["collective_counts"].get("all-gather", 0) > 0, name
        assert 0 < mem["argument_bytes"] <= mem["peak_estimate_bytes"], name
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
