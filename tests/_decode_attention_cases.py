"""Operands and references shared by the decode-attention tests on the CPU
(``test_torch_decode_attention.py``) and on the card
(``test_torch_decode_attention_cuda.py``).

The JAX package is the CPU's reference and never runs on the card, so its
``_sdpa`` at one query a row is computed here on the CPU and stored in
``decode_attention_golden.npz``, at the decode cell's shape and at
MobileLLM-125M's grouped one, on operands that any machine makes bit for
bit from integers (:func:`operands`). The card tests hold the kernel
against the stored outputs; the CPU tests recompute them from the JAX
package. ``python tests/_decode_attention_cases.py`` rewrites the file.

Nothing here imports JAX until :func:`jax_sdpa_decode` is called.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

GOLDEN = Path(__file__).with_name("decode_attention_golden.npz")

# name: (batch, slots, query heads, KV heads, head dim, window, positions)
CASES = {
    # Qwen1.5-MoE-A2.7B's cache in the decode cell: 16 heads of 128, bf16
    "cell": (4, 8192, 16, 16, 128, -1, (0, 4096, 4103, 6143, 8191)),
    # MobileLLM-125M: 9 query heads over 3 KV heads of 64, a window
    "mobilellm_window": (4, 2048, 9, 3, 64, 512, (0, 1000, 2047)),
}

_CHUNK = 1 << 22  # elements hashed at a time, to keep the int64s small
_JITTED: dict = {}  # the JAX reference, compiled once a shape a process


def _hashed(shape, salt: int, scale: float, device) -> torch.Tensor:
    """bf16 values in [-scale, scale) from an integer hash of each element's
    index: exact integer arithmetic, then an exact float of 16 bits and one
    rounding to bf16, so every device and version makes the same bits."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.bfloat16, device=device)
    for at in range(0, n, _CHUNK):
        i = torch.arange(at, min(at + _CHUNK, n), dtype=torch.int64,
                         device=device)
        h = (i * 2654435761 + salt * 97531) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        u = ((h & 0xFFFF).to(torch.float32) - 32768.0) / 32768.0
        out[at:at + i.numel()] = (u * scale).to(torch.bfloat16)
    return out.reshape(shape)


def operands(case: str, device="cpu"):
    """q (B, 1, Hq, D), k and v (B, T, Hkv, D) of a case, bf16. q is four
    times the cache's scale: peaked scores, so a split's max differs from
    the row's."""
    b, t, hq, hkv, d, _, _ = CASES[case]
    return (_hashed((b, 1, hq, d), 1, 4.0, device),
            _hashed((b, t, hkv, d), 2, 1.0, device),
            _hashed((b, t, hkv, d), 3, 1.0, device))


def golden(case: str) -> torch.Tensor:
    """The stored JAX outputs of a case: (positions, B, 1, Hq * D) bf16."""
    with np.load(GOLDEN) as f:
        bits = f[case]
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def jax_sdpa_decode(q, k, v, pos: int, window: int) -> torch.Tensor:
    """The JAX package's ``_sdpa`` for one query a row at ``pos`` over the
    whole cache, as its ``attention_decode`` calls it on a cache neither
    ring nor sliced: (B, 1, Hq * D) in q's dtype, on the CPU."""
    import jax
    import jax.numpy as jnp
    from _torch_jax import fast_jit
    from repro.models import layers as RL

    def to_jax(x):
        if x.dtype == torch.bfloat16:
            return jax.lax.bitcast_convert_type(
                jnp.asarray(x.cpu().view(torch.int16).numpy()), jnp.bfloat16)
        return jnp.asarray(x.cpu().numpy())

    if "sdpa" not in _JITTED:
        _JITTED["sdpa"] = fast_jit(RL._sdpa, static_argnums=5)
    fn = _JITTED["sdpa"]
    rows = jnp.full((1,), pos, jnp.int32)
    cols = jnp.arange(k.shape[1], dtype=jnp.int32)
    out = fn(to_jax(q), to_jax(k), to_jax(v), rows, cols, window)
    if out.dtype == jnp.bfloat16:
        bits = np.array(jax.lax.bitcast_convert_type(out, jnp.int16))
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(out))


def jax_golden(case: str) -> torch.Tensor:
    """What :func:`golden` stores, computed from the JAX package."""
    q, k, v = operands(case)
    window, positions = CASES[case][5], CASES[case][6]
    return torch.stack([jax_sdpa_decode(q, k, v, pos, window)
                        for pos in positions])


def rounding_case(device="cpu"):
    """Two visible positions whose bf16 rounding of the probabilities moves
    the output across a bf16 boundary: scores 0 and -3/1024 (q e0 against
    k rows 0 and -3/128 e0, times 1/8), v rows 0 and 1. Rounded as _sdpa
    rounds them, p1 = exp(-3/1024) is 1 - 2**-8 and the output 0.498046875;
    unrounded it would be 0.5."""
    q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16, device=device)
    k = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16, device=device)
    v = torch.zeros_like(k)
    q[..., 0], k[0, 1, 0, 0], v[0, 1, 0, :] = 1.0, -3 / 128, 1.0
    return q, k, v


def bf16_bound(want: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """How far a bf16 output of the split arithmetic may lie from ``_sdpa``'s
    (either package's): each probability is rounded to bf16 once either
    way, against its split's max here and against the running max there
    (a difference of at most 2**-8 of it, so of 2**-8 max|v| in the
    output), and the output is rounded to bf16 once either way (one ulp,
    2**-8 of it, at most)."""
    return 2**-8 * v.float().abs().max() + 2**-8 * want.float().abs()


if __name__ == "__main__":
    import sys

    sys.path[:0] = [str(Path(__file__).parent),
                    str(Path(__file__).parents[1] / "src")]
    torch.set_num_threads(4)
    np.savez_compressed(GOLDEN, **{
        case: jax_golden(case).view(torch.int16).numpy().view(np.uint16)
        for case in CASES})
    print(f"wrote {GOLDEN}")
