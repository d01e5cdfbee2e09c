"""The latent decode-attention kernel's CPU side (``kernels/mla_decode``): its
plain version (the kernel's split and tile arithmetic) against
``models/mla.py``'s absorbed path at Moonlight-16B-A3B's widths, at
positions on and next to the edges of its splits and tiles, in f32 and
bf16; the splits; the wrapper's refusals; and the gate, which sends the CPU,
f32, a kept gradient, prefill-sized queries and other widths to the absorbed
path. The kernel itself runs only on a card
(``tests/test_torch_mla_decode_cuda.py``)."""

import pytest
import torch

from repro_torch.kernels.mla_decode import kernel as mk
from repro_torch.kernels.mla_decode import plain
from repro_torch.models import mla

torch.set_num_threads(1)

SCALE = 1 / 192 ** 0.5


def operands(b=2, t=512, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, mk.HEADS, mk.WIDTH), generator=g)
    cache = torch.randn((b, t, mk.WIDTH), generator=g)
    return q.to(dtype), cache.to(dtype)


def rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("pos, splits", [(0, 1), (0, 8), (63, 8), (64, 8),
                                         (200, 3), (511, 8), (511, 1),
                                         (600, 4)])
def test_plain_equals_the_absorbed_path(pos, splits):
    """f32 operands: one tile's probabilities rounded to bf16 against its
    running max where the absorbed path rounds them against the row's,
    and f32 sums in another order."""
    q, cache = operands()
    got = plain.mla_decode_plain(q, cache, pos, SCALE, splits)
    want = mla.absorbed(q, cache, pos, mk.LAT, SCALE)
    assert got.shape == want.shape == (2, 1, mk.HEADS, mk.LAT)
    assert rel(got, want) < 4e-3


def test_plain_in_bf16_and_a_position_tensor():
    q, cache = operands(dtype=torch.bfloat16)
    want = mla.absorbed(q, cache, 300, mk.LAT, SCALE)
    got = plain.mla_decode_plain(q, cache, torch.tensor(300), SCALE, 5)
    assert got.dtype == torch.bfloat16 and rel(got, want) < 1e-2
    # positions past 300 never count
    cache[:, 301:] = float("nan")
    assert torch.equal(plain.mla_decode_plain(q, cache, 300, SCALE, 5), got)


def test_split_runs_cover_the_visible_positions_in_tiles():
    for pos, t, splits in ((0, 8192, 8), (512, 8192, 8), (6143, 8192, 8),
                           (9000, 8192, 8), (70, 80, 2)):
        runs = plain.split_runs(pos, t, splits)
        assert len(runs) == splits
        covered = [i for a, b in runs for i in range(a, b)]
        assert covered == list(range(min(pos, t - 1) + 1))
        assert all((b - a) % plain.TILE == 0 or b == min(pos, t - 1) + 1
                   for a, b in runs if b > a)


def test_splits_from_the_shapes_alone():
    assert mk.splits_for(16, 8192, 132) == 8
    assert mk.splits_for(4, 80, 132) == 2
    assert mk.splits_for(200, 8192, 132) == 1
    assert mk.takes(16, 576) and not mk.takes(8, 576) \
        and not mk.takes(16, 512)


@pytest.mark.parametrize("bad, says", [
    (lambda q, c: (q[..., :512], c), "bad operand shapes"),
    (lambda q, c: (q, c[..., :512]), "bad operand shapes"),
    (lambda q, c: (q.float(), c), "unsupported dtypes"),
    (lambda q, c: (q, c.transpose(0, 1).contiguous().transpose(0, 1)),
     "contiguous"),
    (lambda q, c: (q, c), "one CUDA device"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, says):
    q, cache = operands(dtype=torch.bfloat16)
    q, cache = bad(q, cache)
    with pytest.raises(ValueError, match=says):
        mk.mla_decode(q, cache, 3, SCALE)
    with pytest.raises(ValueError):
        mk.check_operands(*operands(dtype=torch.bfloat16), -1)


def test_gate_keeps_the_cpu_and_other_cases_on_the_absorbed_path(
        monkeypatch):
    q, cache = operands(dtype=torch.bfloat16)
    assert not mla._decode_kernel_applies(q, cache)  # the CPU
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda")))
    assert mla._decode_kernel_applies(q, cache)
    assert not mla._decode_kernel_applies(q.float(), cache.float())
    assert not mla._decode_kernel_applies(q.expand(2, 3, 16, 576), cache)
    assert not mla._decode_kernel_applies(q[:, :, :8], cache)
    with torch.enable_grad():
        assert not mla._decode_kernel_applies(q.requires_grad_(), cache)
