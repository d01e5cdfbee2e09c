"""What the tuner asks the CUDA kernels, held to recorded answers.

For every trace of a workload's ``H100`` design space the test records what
``concretize`` makes of it (valid or not, and the shared memory it charges),
the launch key the measuring runner memoises on (``kernels.launch_key``),
and the static analyzer's footprint floor and trace counts
(``static_analysis.feasibility``). It hashes these in the space's own trace
order and compares the hash with the one in
``tests/kernel_families_golden.json``. The workloads are the distinct ops of
the two CNN cells (``portbench/configs``, read through
``portbench.inputs.workload``) and one of each other family and dtype: W3
(MobileLLM-125M's LM head at prefill) in bf16 and f32, N1's LM head gemv in
bf16, ``vmacc(12544, 32)`` f32 and N4's attention, f32 and causal.

A change to a kernel's gate, footprint, floor or launch key moves a hash.
Where the change is meant, rewrite the stored hashes with
``PYTHONPATH=src:. python tests/test_torch_kernel_families.py``.
"""

import hashlib
import json
import os

import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

from portbench import inputs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import H100, Schedule  # noqa: E402
from repro_torch.core import concretize, space_for  # noqa: E402
from repro_torch.core import static_analysis  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
GOLDEN = os.path.join(_HERE, "kernel_families_golden.json")
CELLS = ("mobilenetv2-int8-b96", "resnet18-int8-b64")


def _cell_workloads():
    seen, out = set(), []
    for cell in CELLS:
        with open(os.path.join(_ROOT, "portbench", "configs",
                               cell + ".json")) as f:
            config = json.load(f)
        for op in inputs.unique(config):
            wl = inputs.workload(op)
            if wl.key() not in seen:
                seen.add(wl.key())
                out.append(wl)
    return out


WORKLOADS = _cell_workloads() + [
    W.matmul(64, 1536, 576, "bfloat16"),         # W3
    W.matmul(64, 1536, 576, "float32"),          # W3 f32
    W.gemv(32000, 576, "bfloat16"),              # N1's LM head
    W.vmacc(12544, 32, "float32"),
    W.attention(1, 9, 3, 64, 64, 64, "float32", causal=True),  # N4
]


def answers(wl) -> str:
    """The hash of every trace's (valid, footprint, launch key) and the
    analyzer's floor and counts, for ``wl`` on the H100."""
    report = static_analysis.feasibility(wl, H100)
    rows = [[report.total_traces, report.valid_traces, report.vmem_floor]]
    for t in space_for(wl, H100).traces():
        p = concretize(wl, H100, Schedule.fixed(**t))
        key = kernels.launch_key(p)
        rows.append([sorted(t.items()), p.valid, p.vmem_bytes,
                     None if key is None else list(key)])
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def test_workloads():
    """The two cells hold 40 distinct ops; five more stand for the other
    families."""
    assert len(WORKLOADS) == 45
    assert len({wl.key() for wl in WORKLOADS}) == 45


@pytest.mark.parametrize("wl", WORKLOADS, ids=lambda w: w.key())
def test_answers_match_the_recorded_ones(wl):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert answers(wl) == golden[wl.key()]


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump({wl.key(): answers(wl) for wl in WORKLOADS}, f, indent=1)
        f.write("\n")
