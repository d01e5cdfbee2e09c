"""Helpers of the decode kernels' tests and of ``chip_smoke.py``'s rows: a
CPU tensor that reports a card, for the gates that choose a kernel, and the
distance in bf16 steps between two bf16 tensors. Imports no JAX."""

import torch


class OnCard:
    """A CPU tensor that reports a card: what a gate reads of a CUDA
    operand."""

    def __init__(self, t):
        self.t = t

    @property
    def device(self):
        return torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self.t, name)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart ``got`` and ``want`` lie, elementwise (a
    sign change counts the steps to zero on both sides)."""
    a, b = (t.contiguous().view(torch.int16).int() for t in (got, want))
    mag_a, mag_b = a & 0x7FFF, b & 0x7FFF
    return torch.where((a < 0) == (b < 0), (mag_a - mag_b).abs(),
                       mag_a + mag_b)
