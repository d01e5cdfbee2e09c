"""``layers._sdpa``'s backward (``layers._Attention``) against the
reference's: under autograd it keeps no chunk's scores for the backward,
which recomputes each chunk's scores and probabilities (the reference's
``jax.checkpoint(body, nothing_saveable)``), and its gradients equal
``jax.grad`` of the reference's ``_sdpa``, in f32 and in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from _torch_jax import fast_jit  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


# ------------------------------------------------------- chunk recompute --

def _saved_bytes(s, t, b=1, h=2, d=16):
    """Bytes autograd keeps for ``_sdpa``'s backward at B=1, H=2, D=16:
    what its saved-tensor hooks pack."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, h, d, generator=g, requires_grad=True)
               for n in (s, t, t))
    rows = torch.arange(s, dtype=torch.int32)
    cols = torch.arange(t, dtype=torch.int32)
    saved = [0]

    def pack(x):
        saved[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        L._sdpa(q, k, v, rows, cols)
    return saved[0]


def test_sdpa_keeps_no_chunk_scores_for_the_backward():
    """At S = T = 2048 (two 1024-key chunks) the saved bytes stay within
    a few copies of the (B, H, S, D) f32 output (the parent kept every
    chunk's (B, H, S, C) f32 scores and probabilities: 106.9 MB)."""
    b, h, s, d = 1, 2, 2048, 16
    state = b * h * s * d * 4
    got = _saved_bytes(s, s, b, h, d)
    assert got <= 8 * state, (got, state)
    assert got < b * h * s * L.ATTN_CHUNK * 4  # under one chunk's scores


# (S, T, query heads, KV heads, window, causal, rows' first position),
# with 16-key chunks: three (the last padded), or one (S = T = the chunk)
SDPA_CASES = {
    "gqa-causal": (40, 40, 4, 2, -1, True, 0),
    "window": (40, 40, 4, 4, 8, True, 0),
    "one-chunk": (16, 16, 4, 2, -1, True, 0),
    "cross": (24, 40, 4, 1, -1, False, 0),
    "decode-row": (1, 40, 4, 2, -1, True, 39),
}
# bf16 at the bf16 tolerance of tests/test_kernels.py
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_gradients_equal_the_reference(case, dtype, monkeypatch):
    """Gradients of a weighted sum of the output with 16-key chunks, on
    the same inputs in ``dtype`` (drawn in f32 from a seed and rounded; in
    bf16 the backward's scores and running state are f32, as the
    forward's): the port's (``layers._Attention``'s backward) against
    ``jax.grad`` of the reference's ``_sdpa``, jitted, within ``TOL``."""
    s, t, hq, hkv, window, causal, first = SDPA_CASES[case]
    monkeypatch.setattr(L, "ATTN_CHUNK", 16)
    monkeypatch.setattr(ref_layers, "ATTN_CHUNK", 16)
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, s, hq, 8), (2, t, hkv, 8), (2, t, hkv, 8)))
    w = rng.standard_normal((2, s, hq * 8)).astype(np.float32)
    rows = np.arange(first, first + s, dtype=np.int32)
    cols = np.arange(t, dtype=np.int32)

    def ref_loss(q, k, v):
        return jnp.sum(ref_layers._sdpa(q, k, v, jnp.asarray(rows),
                                        jnp.asarray(cols), window, causal)
                       * jnp.asarray(w, dtype))

    want = fast_jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    qt, kt, vt = (torch.tensor(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = L._sdpa(qt, kt, vt, torch.tensor(rows), torch.tensor(cols),
                  window, causal)
    assert out.dtype == getattr(torch, dtype)
    (out * torch.tensor(w).to(out.dtype)).sum().backward()
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=f"{case} {dtype} d{name}")
