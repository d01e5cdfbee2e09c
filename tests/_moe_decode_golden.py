"""Stored outputs of the decode-step MoE kernel (``csrc/moe_decode.cu``) at
Qwen1.5-MoE-A2.7B's widths, in its softmax routing: for 1, 4 and 16 rows of
one layer drawn from a seed on the card, each row's experts, their weights,
the router's logits and the output's bits. ``test_torch_moe_decode_cuda.py``
holds the kernel to them bit for bit, so that a change to the kernel's
other routing modes leaves this one as it was.

Run on a card, with the package whose kernel is to be stored first on the
path (``PYTHONPATH=<tree>/src``), to rewrite the file:

    python tests/_moe_decode_golden.py [tests/moe_decode_qwen_golden.npz]

The weights come from torch's CUDA generator: a PyTorch whose generator
draws otherwise needs the file written again.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "moe_decode_qwen_golden.npz")
ROWS = (1, 4, 16)
D, E, F, K, SHARED = 2048, 60, 1408, 4, 5632


def layer():
    """One layer at the published widths, bf16, normal of spread 0.02."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02
                ).to(torch.bfloat16)
    return {"router": normal(D, E),
            "experts": {"w_gate": normal(E, D, F), "w_up": normal(E, D, F),
                        "w_down": normal(E, F, D)},
            "shared": {"w_gate": normal(D, SHARED),
                       "w_up": normal(D, SHARED),
                       "w_down": normal(SHARED, D)},
            "shared_gate": normal(D, 1)}


def rows(n: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(100 + n)
    return torch.randn((n, D), generator=gen, device="cuda").to(
        torch.bfloat16)


def outputs(moe_decode) -> dict:
    """The kernel's outputs of each case, as numpy arrays."""
    lp = layer()
    out = {}
    with torch.no_grad():
        for n in ROWS:
            y, r = moe_decode(rows(n), lp["router"], lp["experts"],
                              lp["shared"], lp["shared_gate"], K, False)
            out[f"y_{n}"] = y.view(torch.int16).cpu().numpy()
            out[f"sel_{n}"] = r.sel.cpu().numpy()
            out[f"gates_{n}"] = r.gates.cpu().numpy()
            out[f"logits_{n}"] = r.logits.cpu().numpy()
    return out


def main(argv) -> int:
    from repro_torch.kernels.moe_decode.kernel import moe_decode

    path = argv[1] if len(argv) > 1 else GOLDEN
    np.savez_compressed(path, **outputs(moe_decode))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
