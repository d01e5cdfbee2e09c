"""Wrapper of the CUDA decode-step MoE kernel (``csrc/moe_decode.cu``).

``moe_decode`` is what ``models/moe.py``'s ``moe_ffn`` computes on the
dropless path for a few rows: the routing, the chosen experts' SwiGLU and
their weighted sum, and the shared expert scaled by its gate. It replaces no
kernel of the JAX package, which leaves its MoE layer to XLA's einsums. It
takes CUDA tensors only: it launches the kernel's four launches on the
current stream (span ``moe_decode.launch``), never waits for the card, and
allocates only its output and one scratch buffer of each dtype, so a step
captured as a CUDA graph may call it; it counts the call (counter
``launch._moe_decode``, :mod:`repro_torch.tracing`). ``plain.py`` is the
same arithmetic in PyTorch, which the tests hold it against.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.moe_decode.plain import Routing

MAX_ROWS = 16     # rows a call: the kernel's per-slot row lists
MAX_EXPERTS = 64  # a row's choices as one 64-bit mask
MAX_TOP_K = 8
MAX_WIDTH = 8192  # D: a routing block's row in shared memory
VEC = 8           # D and F are multiples of this: 16-byte loads of bf16


def _lib() -> ctypes.CDLL:
    lib = _build.library("moe_decode")
    if lib.moe_decode_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.moe_decode_launch.argtypes = [p] * 18 + [i] * 8 \
            + [ctypes.c_float, p]
        lib.moe_decode_launch.restype = ctypes.c_int
    return lib


def takes(d: int, f: int, n_experts: int, top_k: int) -> bool:
    """Whether the kernel computes a layer of these widths: D and F
    multiples of :data:`VEC`, D at most :data:`MAX_WIDTH`, at most
    :data:`MAX_EXPERTS` experts and ``top_k`` at most :data:`MAX_TOP_K`."""
    return (d % VEC == 0 and 0 < d <= MAX_WIDTH and f % VEC == 0 and f > 0
            and 0 < n_experts <= MAX_EXPERTS
            and 0 < top_k <= min(MAX_TOP_K, n_experts))


def check_operands(x, router, experts: dict, shared: dict | None,
                   shared_gate, top_k: int, bias=None) -> None:
    """Raise unless ``x (N, D)``, ``router (D, E)``, the experts' w_gate,
    w_up ``(E, D, F)`` and w_down ``(E, F, D)``, the shared expert's w_gate,
    w_up ``(D, P * F)`` and w_down ``(P * F, D)`` (or None), its gate ``(D,
    1)`` (or None) and the correction bias ``(E,)`` (or None) are contiguous
    bf16 tensors starting on 16 bytes on one CUDA device, with ``1 <= N <=
    MAX_ROWS`` and widths :func:`takes` takes. The device is checked last,
    so each other refusal shows on CPU tensors too."""
    if x.dim() != 2 or router.dim() != 2 or router.shape[0] != x.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, router "
                         f"{tuple(router.shape)}")
    n, d = x.shape
    e = router.shape[1]
    wg, wu, wd = experts["w_gate"], experts["w_up"], experts["w_down"]
    if wg.dim() != 3 or wg.shape[:2] != (e, d) or wu.shape != wg.shape \
            or wd.shape != (e, wg.shape[2], d):
        raise ValueError(f"bad expert shapes {tuple(wg.shape)}, "
                         f"{tuple(wu.shape)}, {tuple(wd.shape)} for {e} "
                         f"experts of width {d}")
    f = wg.shape[2]
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"{n} rows: the kernel takes 1 to {MAX_ROWS}")
    if not takes(d, f, e, top_k):
        raise ValueError(f"widths D {d}, F {f}, {e} experts, top-{top_k}: "
                         f"not the kernel's")
    tensors = [x, router, wg, wu, wd]
    if shared is not None:
        sg_, su, sd = shared["w_gate"], shared["w_up"], shared["w_down"]
        fs = sg_.shape[-1]
        if sg_.shape != (d, fs) or su.shape != (d, fs) \
                or sd.shape != (fs, d) or fs == 0 or fs % f:
            raise ValueError(f"bad shared expert shapes {tuple(sg_.shape)}, "
                             f"{tuple(su.shape)}, {tuple(sd.shape)}: widths "
                             f"a multiple of {f}")
        tensors += [sg_, su, sd]
    if shared_gate is not None:
        if shared_gate.shape != (d, 1):
            raise ValueError(f"bad shared expert gate shape "
                             f"{tuple(shared_gate.shape)}")
        tensors.append(shared_gate)
    if bias is not None:
        if bias.shape != (e,):
            raise ValueError(f"bad correction bias shape {tuple(bias.shape)}"
                             f" for {e} experts")
        tensors.append(bias)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"unsupported dtypes "
                         f"{sorted({str(t.dtype) for t in tensors})}: bf16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("operands must start on 16 bytes")
    devices = sorted({str(t.device) for t in tensors})
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"operands on {devices}: the kernel takes one CUDA "
                         f"device")


def _profiled(name: str):
    """While spans are recorded, a profiler scope around the launch: a
    ``torch.profiler`` trace links each card kernel to the operator scope
    open when it was launched, as it links a Triton kernel that
    ``torch.compile`` launches to the scope it opens (this one; a
    ``record_function`` scope links none), and a ``ctypes`` call opens no
    scope of its own. Elsewhere nothing, at no cost."""
    if tracing.recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return contextlib.nullcontext()


def _scratch(sizes: list[int], dtype, device) -> list[torch.Tensor]:
    """One buffer of ``dtype`` cut into views of ``sizes`` elements, each
    starting on 16 bytes (4-byte elements)."""
    padded = [-(-n // 4) * 4 for n in sizes]
    buf = torch.empty(sum(padded), dtype=dtype, device=device)
    starts = itertools.accumulate([0] + padded)
    return [buf[at:at + n] for at, n in zip(starts, sizes)]


def moe_decode(x: torch.Tensor, router: torch.Tensor, experts: dict,
               shared: dict | None, shared_gate, top_k: int,
               norm_topk_prob: bool, *, scoring: str = "softmax", bias=None,
               scale: float = 1.0, sel=None) -> tuple[torch.Tensor, Routing]:
    """The dropless MoE layer of rows ``x (N, D)``: top-``top_k`` routed
    experts plus the shared expert scaled by ``sigmoid(x @ shared_gate)``
    (operands as :func:`check_operands` says). ``scoring="sigmoid"`` routes
    as DeepSeek-V3 does (``plain.route``): the choice on the experts'
    sigmoid scores plus ``bias`` (or None), the weights their unbiased
    scores times ``scale``. ``sel`` (N, top_k) int32 on the device, or
    None: where the chosen experts are written (else the call's scratch).
    Returns ``(y (N, D) bf16, Routing)``, the routing views of the call's
    scratch and ``sel``; the kernel's other scratch holds
    each assignment's and shared part's row of ``silu(g) * u`` (h) and of
    its down product (out), f32."""
    if scoring not in ("softmax", "sigmoid"):
        raise ValueError(f"unknown scoring {scoring!r}: softmax or sigmoid")
    want = (x.shape[0], top_k)
    if sel is not None and (sel.shape != want or sel.dtype != torch.int32
                            or not sel.is_contiguous()
                            or sel.device != x.device):
        raise ValueError(f"sel must be a contiguous {want} int32 on "
                         f"{x.device}")
    check_operands(x, router, experts, shared, shared_gate, top_k, bias)
    n, d = x.shape
    e, _, f = experts["w_gate"].shape
    parts = 0 if shared is None else shared["w_gate"].shape[-1] // f
    work = n * top_k + parts * n  # rows of h and out: assignments, shared
    logits, gates, sg, h, out = _scratch(
        [n * e, n * top_k, n, work * f, work * d], torch.float32, x.device)
    chosen, counts = _scratch([n * top_k, e], torch.int32, x.device)
    if sel is not None:
        chosen = sel
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    sh = shared or {}
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _lib()
    with tracing.span("moe_decode.launch"), _profiled("moe_decode.launch"):
        code = lib.moe_decode_launch(
            x.data_ptr(), router.data_ptr(), ptr(shared_gate), ptr(bias),
            experts["w_gate"].data_ptr(), experts["w_up"].data_ptr(),
            experts["w_down"].data_ptr(), ptr(sh.get("w_gate")),
            ptr(sh.get("w_up")), ptr(sh.get("w_down")), y.data_ptr(),
            logits.data_ptr(), gates.data_ptr(), sg.data_ptr(),
            chosen.data_ptr(), counts.data_ptr(), h.data_ptr(),
            out.data_ptr(),
            n, d, f, e, top_k, parts, int(norm_topk_prob),
            int(scoring == "sigmoid"), scale,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, "_moe_decode", code)
    tracing.count("launch._moe_decode")
    return y, Routing(logits.view(n, e), chosen.view(n, top_k),
                      gates.view(n, top_k), sg, counts)
