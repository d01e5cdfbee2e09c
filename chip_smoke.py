#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

The main path is the paper's tuning loop: a workload -> its design-space
program -> concretized kernel parameters -> a CUDA kernel built from
``src/repro_torch/kernels/csrc`` -> timed on the card by ``CudaRunner`` ->
``tune`` (sampler, evolution, cost model) -> ``TuningDatabase`` ->
``dispatch.kernel_params``. It runs at three workloads of the paper's
networks, unreduced (``benchmarks/nets.py``):

  W1  qmatmul(3136, 64, 576)          ResNet18 stage-1 3x3 conv, int8 im2col
  W2  qmatmul(64, 32000, 576)         MobileLLM-125M LM head, int8
  W3  matmul(64, 1536, 576, bf16)     MobileLLM-125M gate/up projection

Phases (any failure exits nonzero and prints no result line):
  1. the card, its power limit, and the kernels' build (ptxas report);
  2. each kernel against its plain PyTorch version on the same device
     tensors: qmatmul exact, f32 rtol 1e-4 / atol 1e-3 (another sum order),
     bf16 outputs 5e-2; TF32 is off for the plain versions' products;
  3. tune W1-W3 (32 trials, seed 0) with launch counts zeroed just before
     and read just after; dispatch must then resolve "tuned" and the tuned
     kernel's output must equal the plain version's;
  4. per kernel: launches on the main path, time, plain version's time,
     library call's time and the card's bound, as one JSON line.
The last line is {"ok": true, "device": {...}}.

Run:  python3 chip_smoke.py      (needs one CUDA card and nvcc)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TRIALS, SEED = 32, 0


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def bound_ms(tensors_in, tensor_out, ops: float, dtype: str):
    """Least time the card could take: each input read once and the output
    written once at the HBM rate, or the operations at the dtype's peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_in) \
        + tensor_out.numel() * tensor_out.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch import kernels
    from repro_torch.core import (H100, CudaRunner, Schedule, TuningDatabase,
                                  baseline_latency, concretize,
                                  fixed_library_schedule, kernel_params, tune)
    from repro_torch.core import workload as W
    from repro_torch.core.hardware import check_device
    from repro_torch.core.runner import CardTimer, device_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import plain as mm_plain
    from repro_torch.kernels.matmul.kernel import matmul_blocked
    from repro_torch.kernels.matmul.ops import pad2
    from repro_torch.kernels.qmatmul import plain as qmm_plain
    from repro_torch.kernels.qmatmul.kernel import qmatmul_blocked
    from repro_torch.kernels.qmatmul.ops import DEFAULT_SCALE

    # ---------------------------------------------------------------- 1 ----
    phase("1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"device count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    check_device(H100)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: plain f32 products run in full f32")
    out_dir = _build.build_all()
    print(f"kernels built in {os.path.relpath(out_dir, ROOT)}")
    for line in _build.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    print("(shared memory is dynamic: smem_bytes(bm, bn, bk) per launch)")

    wl1 = W.qmatmul(3136, 64, 576)
    wl2 = W.qmatmul(64, 32000, 576)
    wl3 = W.matmul(64, 1536, 576, "bfloat16")
    names = {wl1.key(): "W1", wl2.key(): "W2", wl3.key(): "W3"}

    # ---------------------------------------------------------------- 2 ----
    phase("2. kernels against their plain versions (on the card)")
    err = {"_acc_kernel": 0.0, "_noacc_kernel": 0.0, "_qmm_kernel": 0.0}

    def close(got, want, rtol, atol, what):
        got, want = got.double(), want.double()
        diff = float((got - want).abs().max())
        ok = bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))
        print(f"  {what}: max |diff| {diff:.3g} "
              f"(rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{what} disagrees with its plain version")
        return diff

    def check_matmul(wl, params, label, kernel_name):
        x, w = device_inputs(wl)
        pm, pn, pk = params.padded_dims
        xp, wp = pad2(x, pm, pk).contiguous(), pad2(w, pk, pn).contiguous()
        got = matmul_blocked(xp, wp, params.block, params.order,
                             params.accumulate)
        torch.cuda.synchronize()
        d = close(got, mm_plain.matmul_plain(xp, wp, params.block[2]),
                  1e-4, 1e-3, f"{kernel_name} {label} {params.block} "
                  f"{params.order}")
        err[kernel_name] = max(err[kernel_name], d)
        # the whole op (pad, kernel, slice, cast) against the torch oracle
        out = kernels.build(wl, params)(x, w)
        tol = 5e-2 if wl.dtype == "bfloat16" else 1e-4
        close(out, kernels.reference(wl)(x.float(), w.float()), tol, tol * 10,
              f"  op {label} vs oracle")

    def check_qmatmul(wl, params, label):
        x, w, b = device_inputs(wl)
        pm, pn, pk = params.padded_dims
        xp, wp = pad2(x, pm, pk).contiguous(), pad2(w, pk, pn).contiguous()
        bp = torch.nn.functional.pad(b, (0, pn - b.shape[0])).contiguous()
        got = qmatmul_blocked(xp, wp, bp, DEFAULT_SCALE, params.block)
        torch.cuda.synchronize()
        want = qmm_plain.qmatmul_plain(xp, wp, bp, DEFAULT_SCALE,
                                       params.block[2])
        d = close(got, want, 0.0, 0.0, f"_qmm_kernel {label} {params.block}")
        err["_qmm_kernel"] = max(err["_qmm_kernel"], d)
        close(kernels.build(wl, params)(x, w, b),
              kernels.reference(wl)(x, w, b), 0.0, 0.0,
              f"  op {label} vs oracle")

    wl3_f32 = W.matmul(64, 1536, 576, "float32")
    for wl, label in ((wl3_f32, "W3 f32"), (wl3, "W3 bf16")):
        check_matmul(wl, concretize(wl, H100, fixed_library_schedule(wl, H100)),
                     label, "_acc_kernel")
        nmk = Schedule.fixed(variant="mxu_64", bm=64, bn=64, bk=96,
                             order="nmk", accumulate=True)
        check_matmul(wl, concretize(wl, H100, nmk), label, "_acc_kernel")
    noacc = Schedule.fixed(variant="mxu_64", bm=16, bn=64, bk=64,
                           order="mnk", accumulate=False)
    check_matmul(wl3, concretize(wl3, H100, noacc), "W3 bf16", "_noacc_kernel")
    odd = W.matmul(100, 200, 300, "float32")   # padded to the blocks
    for acc in (True, False):
        s = Schedule.fixed(variant="mxu_64", bm=64, bn=64, bk=64,
                           order="mnk", accumulate=acc)
        p = concretize(odd, H100, s)
        check_matmul(odd, p, f"odd {odd.dims} padded {p.padded_dims}",
                     "_acc_kernel" if acc else "_noacc_kernel")
    for wl, label in ((wl1, "W1"), (wl2, "W2")):
        check_qmatmul(wl, concretize(wl, H100,
                                     fixed_library_schedule(wl, H100)), label)
    oddq = W.qmatmul(33, 65, 17)
    check_qmatmul(oddq, concretize(oddq, H100, Schedule.fixed(
        variant="mxu_min", bm=16, bn=32, bk=32, order="mnk",
        accumulate=True)), f"odd {oddq.dims}")

    # ---------------------------------------------------------------- 3 ----
    phase(f"3. main path: tune W1-W3 ({TRIALS} trials, seed {SEED}), "
          f"database, dispatch")
    runner = CudaRunner(H100)
    db = TuningDatabase()
    results = {}
    kernels.reset_launch_counts()
    for wl in (wl1, wl2, wl3):
        res = tune(wl, H100, runner, trials=TRIALS, seed=SEED, database=db)
        t_fixed = runner.run(wl, fixed_library_schedule(wl, H100))
        params, provenance = kernel_params(wl, H100, database=db)
        inputs = runner.inputs(wl)
        out = kernels.build(wl, params)(*inputs)
        torch.cuda.synchronize()
        results[wl.key()] = (res, params, provenance, out, t_fixed)
    launches = kernels.launch_counts()
    print(f"launches on the main path: {launches}")

    for wl in (wl1, wl2, wl3):
        res, params, provenance, out, t_fixed = results[wl.key()]
        n_invalid = sum(1 for _, lat in res.history if lat == float("inf"))
        t_lib = baseline_latency(wl)
        print(f"  {names[wl.key()]} {wl.key()}: tuned {res.best_latency*1e6:.2f} us "
              f"{res.best_schedule.as_dict()}; library schedule "
              f"{t_fixed*1e6:.2f} us; baseline (torch) {t_lib*1e6:.2f} us; "
              f"{n_invalid} INVALID of {res.trials}; dispatch: {provenance}")
        if not res.best_latency < float("inf"):
            raise RuntimeError(f"{wl.key()}: no finite latency")
        if provenance != "tuned":
            raise RuntimeError(f"{wl.key()}: dispatch resolved {provenance}")
        x = runner.inputs(wl)
        pm, pn, pk = params.padded_dims
        if wl.op == "qmatmul":
            xp, wp = pad2(x[0], pm, pk), pad2(x[1], pk, pn)
            bp = torch.nn.functional.pad(x[2], (0, pn - x[2].shape[0]))
            want = qmm_plain.qmatmul_plain(xp, wp, bp, DEFAULT_SCALE,
                                           params.block[2])
            close(out, want[:wl.dims[0], :wl.dims[1]], 0.0, 0.0,
                  f"  tuned {names[wl.key()]} vs plain")
        else:
            want = mm_plain.matmul_plain(pad2(x[0], pm, pk), pad2(x[1], pk, pn),
                                         params.block[2])
            close(out, want[:wl.dims[0], :wl.dims[1]].to(out.dtype), 5e-2,
                  5e-1, f"  tuned {names[wl.key()]} vs plain")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"{name} was not launched on the main path")

    # ---------------------------------------------------------------- 4 ----
    phase("4. kernel times at the main path's shapes")
    timer = CardTimer(repeats=20, warmup=3)

    def best_of(wl, accumulate=None):
        hist = [(lat, s) for s, lat in results[wl.key()][0].history
                if lat < float("inf")]
        if accumulate is not None:
            hist = [(lat, s) for lat, s in hist
                    if concretize(wl, H100, s).accumulate == accumulate]
        return concretize(wl, H100, min(hist, key=lambda r: r[0])[1])

    rows = []

    def row(name, wl, params):
        x = runner.inputs(wl)
        pm, pn, pk = params.padded_dims
        xp = pad2(x[0], pm, pk).contiguous()
        wp = pad2(x[1], pk, pn).contiguous()
        ops = 2.0 * pm * pn * pk
        if wl.op == "qmatmul":
            bp = torch.nn.functional.pad(x[2], (0, pn - x[2].shape[0]))
            args = (xp, wp, bp, DEFAULT_SCALE, params.block)
            kern, plain_fn = qmatmul_blocked, (
                lambda *a: qmm_plain.qmatmul_plain(*a[:4], params.block[2]))
            bound, by = bound_ms((xp, wp, bp), kern(*args), ops, "int8")
        else:
            args = (xp, wp, params.block, params.order, params.accumulate)
            kern, plain_fn = matmul_blocked, (
                lambda *a: mm_plain.matmul_plain(a[0], a[1], params.block[2]))
            bound, by = bound_ms((xp, wp), kern(*args), ops, wl.dtype)
        r = {"name": name, "route": "cuda",
             "source": ("src/repro_torch/kernels/csrc/qmatmul.cu"
                        if wl.op == "qmatmul"
                        else "src/repro_torch/kernels/csrc/matmul.cu"),
             "replaces": {"_acc_kernel": "src/repro/kernels/matmul/kernel.py:25",
                          "_noacc_kernel": "src/repro/kernels/matmul/kernel.py:42",
                          "_qmm_kernel": "src/repro/kernels/qmatmul/kernel.py:25"}[name],
             "launches": launches[name], "max_abs_err": err[name],
             "ms": timer(kern, args) * 1e3,
             "plain_ms": timer(plain_fn, args) * 1e3,
             "bound_ms": bound, "bound_by": by,
             "library_ms": timer(kernels.baseline(wl), x) * 1e3,
             "workload": names[wl.key()], "block": list(params.block)}
        rows.append(r)
        print(f"  {name} {r['workload']} block {params.block}: kernel "
              f"{r['ms']*1e3:.2f} us, plain {r['plain_ms']*1e3:.2f} us, "
              f"library {r['library_ms']*1e3:.2f} us, bound "
              f"{r['bound_ms']*1e3:.3f} us ({by})")
        return r

    acc3 = row("_acc_kernel", wl3, best_of(wl3, accumulate=True))
    noacc3 = row("_noacc_kernel", wl3, best_of(wl3, accumulate=False))
    row("_qmm_kernel", wl1, best_of(wl1))
    qmm2 = row("_qmm_kernel", wl2, best_of(wl2))
    print("rows " + json.dumps(rows))
    print(card_line)
    strip = ("workload", "block")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in strip}
                                  for r in (acc3, noacc3, qmm2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
