#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

The main path is the paper's tuning loop: a workload -> its design-space
program -> concretized kernel parameters -> a CUDA kernel built from
``src/repro_torch/kernels/csrc`` -> timed on the card by ``CudaRunner`` ->
``tune`` (sampler, evolution, cost model) -> ``TuningDatabase`` ->
``dispatch.kernel_params``. Two paths drive it, each at the published
widths, unreduced:

- one operator at a time (``tune``), at three workloads of the paper's
  networks (``benchmarks/nets.py``):

    W1  qmatmul(3136, 64, 576)          ResNet18 stage-1 3x3 conv, int8 im2col
    W2  qmatmul(64, 32000, 576)         MobileLLM-125M LM head, int8
    W3  matmul(64, 1536, 576, bf16)     MobileLLM-125M gate/up projection

- whole networks through ``TuningSession`` and ``ensure_tuned``:
  MobileLLM-125M's batch-1 decode step (``runtime.serve_loop.decode_ops``:
  five bf16 gemv workloads, the 32000 x 576 LM head among them) and
  MobileNetV2 int8 at 224 x 224 (``repro_torch.nets.mobilenetv2``: 18
  qmatmul and 6 vmacc workloads), the session interleaving measurement on
  the card with search on the host (pipeline depth 2);

- the attention path: BERT-tiny int8 and MobileLLM-125M int8 prefill at
  sequence 64 (``repro_torch.nets.bert_tiny`` / ``mobilellm_125m``: the
  f32 attention workloads, non-causal MHA and causal GQA, beside their
  int8 projections) through ``TuningSession`` at pipeline depth 2;

- the bf16 tensor-core matmul: MobileLLM-125M bf16 prefill at sequence 64
  (``repro_torch.nets.mobilellm_125m("bfloat16")``: 211 bf16 matmul calls
  at 5 unique shapes, the 64 x 32000 x 576 LM head among them, beside the
  f32 attention) through ``TuningSession`` at pipeline depth 2;

- the f32 (3xTF32) tensor-core matmul: MobileNetV2 f32 at 224 x 224
  (``repro_torch.nets.mobilenetv2("float32")``: 36 f32 im2col matmul calls
  at 16 unique shapes, 153 vmacc calls at 7 and the 1000 x 1280 f32 gemv
  classifier) and the DCGAN
  generator (``repro_torch.nets.dcgan()``: 5 f32 matmuls) through
  ``TuningSession`` at pipeline depth 2;

- long-context attention (N8): the attention workloads of MobileLLM-125M
  at its max_seq_len 2048 (``attention(1, 9, 3, 2048, 2048, 64)`` f32
  causal GQA, x30) and BERT-tiny at its 512 (``attention(1, 2, 2, 512, 512,
  64)`` f32 MHA, x2), taken from ``repro_torch.nets.mobilellm_125m("int8",
  seq=2048)`` and ``bert_tiny("int8", seq=512)``, through
  ``TuningSession`` at pipeline depth 2.

The int8 qmatmul and the vmacc kernels take their operands at the real
size (``qmatmul_ragged``, ``vmacc_ragged``: the wrappers pad nothing);
their padded entries (``qmatmul_blocked``, ``vmacc_blocked``) stay the
Pallas kernels' contract and are held too.

Phases (any failure exits nonzero and prints no result line):
  1. the card, its power limit, and the kernels' build (ptxas report: the
     registers and spills of the bf16 and f32 tensor-core kernels, the
     gemv, the qmatmul, the vmacc and the attention kernels); ``cuobjdump
     -sass`` of the matmul library must show HMMA, the tensor cores'
     instruction, in every bf16 kernel and HMMA.*.F32.TF32 in every f32
     kernel, that of the qmatmul library IMMA (the integer one) in every
     kernel, those of the gemv and vmacc libraries a 128-bit global load in
     every kernel with 16-byte vectors, and that of the attention library
     HMMA in every kernel and HMMA.1688.F32.TF32 in every f32 one;
  2. each kernel against its plain PyTorch version on the same device
     tensors: qmatmul exact, f32 and bf16 matmul rtol 1e-4 / atol 1e-3
     (another sum order; bf16 products are exact in f32), bf16 op outputs
     5e-2, vmacc 1e-5, attention 2e-3 (f32 and bf16, and on peaked
     scores, q scaled by Q_SHARP); TF32 is off for the plain versions'
     products. The f32 (3xTF32) matmul kernels, acc in both orders and at
     cluster caps 1, 2, 4 and the rule's, and noacc, at every block the H100
     spaces of W3 in f32, an odd 100x200x300, MobileNetV2 f32's 12544x32x27,
     3136x24x96 and 49x1280x320 and DCGAN's 16x512x100 and 4096x3x256
     offer (F32_SHAPES); the bf16 matmul kernels at W3, at every block the bf16 LM
     head's space offers (so at its tuned block), and at blocks off the
     power-of-two ladder (bn 48, bk 16, bm 128, 80 x 112); both gemv
     entries, f32 and bf16, at rtol 1e-4 / atol 1e-3 at every bn the
     decode step's spaces offer, bk 16 and 1024, J = 1 at odd pn and both
     sides of _gemv_kernel's cluster choice; the unpadded _qmm_kernel
     exact at MobileNetV2's, MobileLLM-125M prefill's and W1/W2's shapes
     (QMM_SHAPES), at every block their H100 spaces offer, with K split by
     the kernel's rule and over no cluster, and on operands off the 16-byte
     grain; the unpadded _vmacc_kernel at 1e-5 on ragged shapes, f32 and
     bf16, vector and scalar paths (a view at an odd offset); _fa_kernel
     at N3's, N4's and N8's shapes (seq 64, 512 and 2048) at split and
     unsplit blocks, the ragged and no-visible-key shapes;
  3. tune W1-W3 (32 trials, seed 0) with launch counts zeroed just before
     and read just after; no candidate may be INVALID, dispatch must then
     resolve "tuned" and the tuned kernel's output must equal the plain
     version's;
  4. tune the two networks with launch counts zeroed just before and read
     just after; every unique workload must then resolve "tuned" and its
     tuned kernel's output equal the plain version's; per network the
     tuned, fixed-library and library-call latencies (each the sum of
     count x latency) and the session's overlap fraction;
  4b. the same for the two prefill networks (the attention path), with
     their own launch counts;
  4c. the same for MobileLLM-125M bf16 prefill, with its own launch counts;
     ``_acc_kernel`` must launch there;
  4d. the same for MobileNetV2 f32 and DCGAN f32, with their own launch
     counts; the f32 ``_acc_kernel`` must launch there;
  4e. the same for the long-context attention workloads (N8), with their
     own launch counts; ``_fa_kernel`` must launch there;
  5. the timer's floor (a one-element fill_, a 16x16 gemv); _gemv_kernel at
     the down projection and _qmm_kernel at 64 x 576 x 1536 with and
     without their clusters; a torch.profiler count of the card's kernels in
     one ``kernels.build(wl, params)`` call at MobileNetV2's 196 x 192 vmacc
     and 12544 x 32 x 27 qmatmul, which must be 1; per kernel:
     launches on the main paths (phases 3 to 4e), time,
     plain version's time, library call's time and the card's bound, as one
     JSON line (``_acc_kernel`` and ``_noacc_kernel`` at W3, the gemv
     kernels at the LM head, ``_fa_kernel`` at MobileLLM's prefill at seq
     64 and 2048; ``_acc_kernel`` at the bf16 LM head, both gemv kernels at
     the decode step's down and up projections, ``_fa_kernel`` at BERT-tiny
     seq 512 (its tuned blocks; SDPA's backend named beside each attention
     row), ``_qmm_kernel`` at MobileLLM prefill's 64 x
     576 x 1536 and MobileNetV2's classifier 1 x 1000 x 1280,
     ``_vmacc_kernel`` at 196 x 192 are on the line of all rows; the f32
     ``_acc_kernel`` and ``_noacc_kernel`` at W3, the f32 ``_acc_kernel`` at
     MobileNetV2 f32's costliest matmul and DCGAN's 1024 x 64 x 512 on
     both; the 3xTF32 figure beside the bound of every f32 matmul and
     attention row). A row's bound counts
     the bytes and operations of the operands the path hands the kernel:
     the real, unpadded ones for qmatmul and vmacc.
The last line is {"ok": true, "device": {...}}.

Run:  python3 chip_smoke.py      (needs one CUDA card and nvcc)
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TRIALS, SEED = 32, 0
# Network phase budgets: trials per unique workload of each network.
DECODE_TRIALS, MNV2_TRIALS, PREFILL_TRIALS, DCGAN_TRIALS = 32, 16, 16, 32
# Dense TF32 peak of the H100 SXM (NVIDIA data sheet): 3xTF32 issues three
# TF32 products per f32 product.
PEAK_TF32 = 494.7e12
# q times this turns example_inputs' near-uniform attention (operands of
# standard deviation 0.5, scores of 0.25) into a peaked one (scores of 4).
Q_SHARP = 16.0
SLICE1 = ("_acc_kernel", "_noacc_kernel", "_qmm_kernel")
SLICE2 = ("_qmm_kernel", "_gemv_kernel", "_gemv_noacc_kernel",
          "_vmacc_kernel")
SLICE3 = ("_qmm_kernel", "_fa_kernel")
SLICE4 = ("_acc_kernel",)
SLICE7 = ("_acc_kernel",)
SLICE8 = ("_fa_kernel",)
# The f32 matmul kernels' shapes in phase 2: W3 in f32, an odd shape,
# MobileNetV2 f32's (N6) 12544x32x27, 3136x24x96 and 49x1280x320 and
# DCGAN's (N7) 16x512x100 and 4096x3x256.
F32_SHAPES = ((64, 1536, 576), (100, 200, 300), (12544, 32, 27),
              (3136, 24, 96), (49, 1280, 320), (16, 512, 100),
              (4096, 3, 256))
# The unpadded _qmm_kernel's shapes in phase 2: MobileNetV2 int8 (N2),
# MobileLLM-125M int8 prefill (N4), W1 and W2.
QMM_SHAPES = ((12544, 32, 27), (784, 144, 24), (3136, 24, 96),
              (49, 160, 576), (1, 1000, 1280), (64, 576, 1536),
              (3136, 64, 576), (64, 32000, 576))
REPLACES = {
    "_acc_kernel": "src/repro/kernels/matmul/kernel.py:25",
    "_noacc_kernel": "src/repro/kernels/matmul/kernel.py:42",
    "_qmm_kernel": "src/repro/kernels/qmatmul/kernel.py:25",
    "_gemv_kernel": "src/repro/kernels/gemv/kernel.py:23",
    "_gemv_noacc_kernel": "src/repro/kernels/gemv/kernel.py:38",
    "_vmacc_kernel": "src/repro/kernels/vmacc/kernel.py:20",
    "_fa_kernel": "src/repro/kernels/flash_attention/kernel.py:25",
}
SOURCE = {
    "_acc_kernel": "src/repro_torch/kernels/csrc/matmul.cu",
    "_noacc_kernel": "src/repro_torch/kernels/csrc/matmul.cu",
    "_qmm_kernel": "src/repro_torch/kernels/csrc/qmatmul.cu",
    "_gemv_kernel": "src/repro_torch/kernels/csrc/gemv.cu",
    "_gemv_noacc_kernel": "src/repro_torch/kernels/csrc/gemv.cu",
    "_vmacc_kernel": "src/repro_torch/kernels/csrc/vmacc.cu",
    "_fa_kernel": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def bound_ms(tensors_in, tensor_out, ops: float, dtype: str):
    """Least time the card could take: each input read once and the output
    written once at the HBM rate, or the operations at the dtype's peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_in) \
        + tensor_out.numel() * tensor_out.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_resources(log: str, label) -> dict:
    """Registers and spill bytes (stores, loads) that ``ptxas -v`` reports
    for each kernel that ``label`` (mangled name -> readable name or None)
    names, by its readable name."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = label(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {})["spills"] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m[1])
    return out


def attention_visible_ops(wl) -> float:
    """Operations attention needs on this workload: QK^T and PV, two
    multiply-adds each per visible (query, key) pair and head dim, whatever
    the block. Causal rows see the keys up to the bottom-right diagonal."""
    b, hq, _hkv, lq, lkv, d = wl.dims
    if "causal" in wl.tags:
        pairs = sum(min(lkv, max(0, i + lkv - lq + 1)) for i in range(lq))
    else:
        pairs = lq * lkv
    return 4.0 * b * hq * pairs * d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch import kernels, nets
    from repro_torch.configs import get_config
    from repro_torch.core import (H100, CudaRunner, Schedule, TuningDatabase,
                                  TuningSession, baseline_latency, concretize,
                                  ensure_tuned, fixed_library_schedule,
                                  kernel_params, space_for, tune)
    from repro_torch.core import workload as W
    from repro_torch.core.hardware import check_device
    from repro_torch.core.runner import CardTimer, device_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_blocked, plain_version as fa_plain)
    from repro_torch.kernels.gemv import ops as gemv_ops
    from repro_torch.kernels.gemv import plain as gemv_plain
    from repro_torch.kernels.gemv.kernel import gemv_blocked
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import plain as mm_plain
    from repro_torch.kernels.matmul.kernel import matmul_blocked
    from repro_torch.kernels.matmul.ops import pad2
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul import plain as qmm_plain
    from repro_torch.kernels.qmatmul.kernel import (qmatmul_blocked,
                                                    qmatmul_ragged)
    from repro_torch.kernels.qmatmul.ops import DEFAULT_SCALE
    from repro_torch.kernels.vmacc import ops as vmacc_ops
    from repro_torch.kernels.vmacc import plain as vmacc_plain
    from repro_torch.kernels.vmacc.kernel import vmacc_blocked, vmacc_ragged
    from repro_torch.runtime.serve_loop import decode_ops

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
    print("bf16 tensor-core kernels (matmul.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), mm_ops.bf16_kernel_label)
    sass = {mm_ops.bf16_kernel_label(name): body
            for name, body in _build.sass("matmul").items()
            if mm_ops.bf16_kernel_label(name)}
    if not sass or set(sass) != set(resources):
        raise RuntimeError(f"bf16 kernels in the SASS {sorted(sass)} and the "
                           f"ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_hmma = sum("HMMA" in line for line in body.splitlines())
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_hmma} HMMA "
              f"instructions")
        if n_hmma == 0:
            raise RuntimeError(f"{label} has no HMMA: not on the tensor cores")
    print("f32 3xTF32 tensor-core kernels (matmul.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), mm_ops.kernel_label)
    sass = {mm_ops.kernel_label(name): body
            for name, body in _build.sass("matmul").items()
            if mm_ops.kernel_label(name)}
    if len(sass) != 10 or set(sass) != set(resources):
        raise RuntimeError(f"f32 kernels in the SASS {sorted(sass)} and the "
                           f"ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_tf32 = len(mm_ops.HMMA_TF32.findall(body))
        spelled = sorted(set(mm_ops.HMMA_TF32.findall(body)))
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_tf32} "
              f"{'/'.join(spelled) or 'HMMA.*.F32.TF32'} instructions")
        if n_tf32 == 0:
            raise RuntimeError(f"{label} has no TF32 HMMA: not on the tensor "
                               f"cores")
    print("gemv kernels (gemv.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), gemv_ops.kernel_label)
    sass = {gemv_ops.kernel_label(name): body
            for name, body in _build.sass("gemv").items()
            if gemv_ops.kernel_label(name)}
    if len(sass) != 8 or set(sass) != set(resources):
        raise RuntimeError(f"gemv kernels in the SASS {sorted(sass)} and the "
                           f"ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_128 = len(gemv_ops.LDG_128.findall(body))
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_128} 128-bit "
              f"global loads")
        if ",1," not in label and n_128 == 0:
            raise RuntimeError(f"{label} has no 128-bit global load")
    print("int8 tensor-core qmatmul kernels (qmatmul.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), qmm_ops.kernel_label)
    sass = {qmm_ops.kernel_label(name): body
            for name, body in _build.sass("qmatmul").items()
            if qmm_ops.kernel_label(name)}
    if len(sass) != 4 or set(sass) != set(resources):
        raise RuntimeError(f"qmatmul kernels in the SASS {sorted(sass)} and "
                           f"the ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_imma = len(qmm_ops.IMMA.findall(body))
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_imma} IMMA "
              f"instructions")
        if n_imma == 0:
            raise RuntimeError(f"{label} has no IMMA: not on the tensor cores")
    print("vmacc kernels (vmacc.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), vmacc_ops.kernel_label)
    sass = {vmacc_ops.kernel_label(name): body
            for name, body in _build.sass("vmacc").items()
            if vmacc_ops.kernel_label(name)}
    if len(sass) != 4 or set(sass) != set(resources):
        raise RuntimeError(f"vmacc kernels in the SASS {sorted(sass)} and the "
                           f"ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_128 = len(gemv_ops.LDG_128.findall(body))
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_128} 128-bit "
              f"global loads")
        if not label.endswith(",1>") and n_128 == 0:
            raise RuntimeError(f"{label} has no 128-bit global load")
    print("attention kernels (flash_attention.cu), ptxas and SASS:")
    resources = ptxas_resources(_build.build_log(), fa_ops.kernel_label)
    sass = {fa_ops.kernel_label(name): body
            for name, body in _build.sass("flash_attention").items()
            if fa_ops.kernel_label(name)}
    if set(sass) != set(fa_ops.kernel_labels()) or \
            set(sass) != set(resources):
        raise RuntimeError(f"attention kernels in the SASS {sorted(sass)} and "
                           f"the ptxas report {sorted(resources)} differ")
    for label, body in sorted(sass.items()):
        n_hmma = len(fa_ops.HMMA.findall(body))
        n_tf32 = body.count("HMMA.1688.F32.TF32")
        res = resources[label]
        print(f"  {label}: {res['registers']} registers, spill stores/loads "
              f"{res['spills'][0]}/{res['spills'][1]} bytes, {n_hmma} HMMA "
              f"instructions, {n_tf32} of them HMMA.1688.F32.TF32")
        if n_hmma == 0:
            raise RuntimeError(f"{label} has no HMMA: not on the tensor cores")
        if "f32" in label and n_tf32 == 0:
            raise RuntimeError(f"{label} has no HMMA.1688.F32.TF32: not "
                               f"3xTF32 on the tensor cores")

    wl1 = W.qmatmul(3136, 64, 576)
    wl2 = W.qmatmul(64, 32000, 576)
    wl3 = W.matmul(64, 1536, 576, "bfloat16")
    lm_head_mm = W.matmul(64, 32000, 576, "bfloat16")   # MobileLLM prefill
    names = {wl1.key(): "W1", wl2.key(): "W2", wl3.key(): "W3"}
    lm_head = W.gemv(32000, 576, "bfloat16")   # MobileLLM-125M decode
    down_proj = W.gemv(576, 1536, "bfloat16")
    up_proj = W.gemv(1536, 576, "bfloat16")
    dw1 = W.vmacc(12544, 32)                   # MobileNetV2's first dw stage

    # ---------------------------------------------------------------- 2 ----
    phase("2. kernels against their plain versions (on the card)")
    err = {name: 0.0 for name in REPLACES}

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

    def check_gemv(wl, decisions, label):
        params = concretize(wl, H100, Schedule.fixed(**decisions))
        if not params.valid:
            raise RuntimeError(f"{label}: {params.why_invalid}")
        x, w = device_inputs(wl)
        pn, pk = params.padded_dims
        xp, wp = pad2(x, 1, pk).contiguous(), pad2(w, pk, pn).contiguous()
        got = gemv_blocked(xp, wp, params.block, params.accumulate)
        torch.cuda.synchronize()
        name = "_gemv_kernel" if params.accumulate else "_gemv_noacc_kernel"
        # f32 output for both dtypes; bf16 products are exact in f32
        rtol, atol = (5e-2, 5e-2) if wl.dtype == "bfloat16" else (1e-4, 1e-3)
        d = close(got, gemv_plain.gemv_plain(xp, wp, params.block[1]), rtol,
                  atol, f"{name} {label} {params.block} padded "
                  f"{params.padded_dims}")
        err[name] = max(err[name], d)
        out = kernels.build(wl, params)(x, w)
        if out.dtype != torch.float32:
            raise RuntimeError(f"gemv {label} returned {out.dtype}")
        close(out, kernels.reference(wl)(x, w), rtol, atol,
              f"  op {label} vs oracle")

    def check_vmacc(wl, decisions, label):
        params = concretize(wl, H100, Schedule.fixed(**decisions))
        if not params.valid:
            raise RuntimeError(f"{label}: {params.why_invalid}")
        a, b, c = device_inputs(wl)
        pr, pc = params.padded_dims
        ap, bp, cp = (pad2(t, pr, pc).contiguous() for t in (a, b, c))
        got = vmacc_blocked(ap, bp, cp, params.block)
        torch.cuda.synchronize()
        d = close(got, vmacc_plain.vmacc_plain(ap, bp, cp), 1e-5, 1e-5,
                  f"_vmacc_kernel {label} {params.block} padded "
                  f"{params.padded_dims}")
        err["_vmacc_kernel"] = max(err["_vmacc_kernel"], d)
        close(kernels.build(wl, params)(a, b, c),
              kernels.reference(wl)(a, b, c), 1e-5, 1e-5,
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

    def check_f32(dims, label):
        """Both f32 (3xTF32) entries at every block the shape's H100 space
        offers, on the workload's inputs padded to it: _acc_kernel in both
        orders and at cluster caps 1, 2, 4 and the rule's (8), and
        _noacc_kernel, against the plain version at rtol 1e-4 / atol 1e-3.
        One line per shape."""
        wl = W.matmul(*dims, "float32")
        x, w = device_inputs(wl)
        blocks = sorted({concretize(wl, H100, Schedule.fixed(**t)).block
                         for t in space_for(wl, H100).traces()})
        top = mm_ops.F32_MAX_CLUSTER
        clusters = set()
        diffs = {"_acc_kernel": 0.0, "_noacc_kernel": 0.0}
        for block in blocks:
            pm, pn, pk = (math.ceil(d / b) * b for d, b in zip(dims, block))
            xp, wp = pad2(x, pm, pk).contiguous(), pad2(w, pk, pn).contiguous()
            want = mm_plain.matmul_plain(xp, wp, block[2]).double()
            for order, acc, cap in (("mnk", True, top), ("nmk", True, top),
                                    ("mnk", True, 1), ("mnk", True, 2),
                                    ("mnk", True, 4), ("mnk", False, top)):
                name = "_acc_kernel" if acc else "_noacc_kernel"
                got = matmul_blocked(xp, wp, block, order, acc, cap)
                torch.cuda.synchronize()
                diff = (got.double() - want).abs()
                if not bool(torch.all(diff <= 1e-3 + 1e-4 * want.abs())):
                    raise RuntimeError(f"{name} f32 {label} {dims} {block} "
                                       f"{order} cap {cap} disagrees with "
                                       f"its plain version")
                diffs[name] = max(diffs[name], float(diff.max()))
                if acc:
                    clusters.add(mm_ops.plan(pm, pn, pk, *block, True,
                                             cap).cluster)
        for name, d in diffs.items():
            err[name] = max(err[name], d)
        print(f"  f32 {label} {dims}: {len(blocks)} blocks x (acc mnk/nmk, "
              f"caps 1/2/4/{top}; noacc), clusters {sorted(clusters)}: max "
              f"|diff| acc {diffs['_acc_kernel']:.3g}, noacc "
              f"{diffs['_noacc_kernel']:.3g} (rtol 1e-4, atol 1e-3) ok")

    for dims, label in zip(F32_SHAPES, ("W3", "odd", "N6", "N6", "N6", "N7",
                                        "N7")):
        check_f32(dims, label)

    def check_tensor_core(wl, block, label):
        """Both bf16 tensor-core entries against the plain version on the
        workload's inputs, padded to ``block``: _acc_kernel in both orders
        and _noacc_kernel. One line per block."""
        x, w = device_inputs(wl)
        m, n, k = wl.dims
        pm, pn, pk = (math.ceil(d / b) * b for d, b in zip((m, n, k), block))
        xp, wp = pad2(x, pm, pk).contiguous(), pad2(w, pk, pn).contiguous()
        want = mm_plain.matmul_plain(xp, wp, block[2]).double()
        diffs = []
        for name, order, acc in (("_acc_kernel", "mnk", True),
                                 ("_acc_kernel", "nmk", True),
                                 ("_noacc_kernel", "mnk", False)):
            got = matmul_blocked(xp, wp, block, order, acc)
            torch.cuda.synchronize()
            diff = (got.double() - want).abs()
            if not bool(torch.all(diff <= 1e-3 + 1e-4 * want.abs())):
                raise RuntimeError(f"{name} {label} {block} {order} bf16 "
                                   f"disagrees with its plain version")
            diffs.append(float(diff.max()))
            err[name] = max(err[name], diffs[-1])
        print(f"  bf16 {label} {block} padded {(pm, pn, pk)}: max |diff| "
              f"acc mnk {diffs[0]:.3g}, acc nmk {diffs[1]:.3g}, noacc "
              f"{diffs[2]:.3g} (rtol 1e-4, atol 1e-3) ok")

    for block in ((64, 64, 64), (16, 64, 64), (16, 48, 16), (128, 64, 64)):
        check_tensor_core(wl3, block, "W3")
    lm_blocks = sorted({concretize(lm_head_mm, H100, Schedule.fixed(**t)).block
                        for t in space_for(lm_head_mm, H100).traces()})
    for block in lm_blocks:
        check_tensor_core(lm_head_mm, block, "LM head")
    odd_bf16 = W.matmul(100, 200, 300, "bfloat16")
    for block in ((80, 112, 16), (48, 48, 16), (32, 48, 32)):
        check_tensor_core(odd_bf16, block, f"odd {odd_bf16.dims}")
    for wl, label in ((wl1, "W1"), (wl2, "W2")):
        check_qmatmul(wl, concretize(wl, H100,
                                     fixed_library_schedule(wl, H100)), label)
    oddq = W.qmatmul(33, 65, 17)
    check_qmatmul(oddq, concretize(oddq, H100, Schedule.fixed(
        variant="mxu_min", bm=16, bn=32, bk=32, order="mnk",
        accumulate=True)), f"odd {oddq.dims}")

    check_gemv(lm_head, fixed_library_schedule(lm_head, H100).as_dict(),
               "LM head (library schedule)")
    for acc in (True, False):
        check_gemv(lm_head, dict(variant="vl_128", bn=128, bk=64,
                                 accumulate=acc), "LM head")
        check_gemv(W.gemv(960, 576, "bfloat16"),
                   dict(variant="j1", bn=1, bk=64, accumulate=acc), "QKV j1")
        check_gemv(W.gemv(100, 300, "float32"),
                   dict(variant="vl_16", bn=16, bk=64, accumulate=acc),
                   "odd 100x300 f32")
        check_gemv(W.gemv(1536, 576, "float32"),
                   dict(variant="vl_128", bn=128, bk=96, accumulate=acc),
                   "up f32")

    def check_gemv_block(n, k, block, label):
        """Both gemv entries at ``block``, f32 and bf16, on random operands
        padded to it, against the plain version at rtol 1e-4 / atol 1e-3
        (bf16 products are exact in f32: only the sum order differs)."""
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        pn, pk = (math.ceil(d / b) * b for d, b in zip((n, k), block))
        diffs = []
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(1, pk, device="cuda", generator=gen).to(dtype)
            w = torch.randn(pk, pn, device="cuda", generator=gen).to(dtype)
            want = gemv_plain.gemv_plain(x, w, block[1]).double()
            for name, acc in (("_gemv_kernel", True),
                              ("_gemv_noacc_kernel", False)):
                got = gemv_blocked(x, w, block, acc)
                torch.cuda.synchronize()
                diff = (got.double() - want).abs()
                if not bool(torch.all(diff <= 1e-3 + 1e-4 * want.abs())):
                    raise RuntimeError(f"{name} {label} {block} {dtype} "
                                       f"disagrees with its plain version")
                diffs.append(float(diff.max()))
                err[name] = max(err[name], diffs[-1])
        cluster = gemv_ops.plan(pn, pk, *block, "bfloat16", True).cluster
        print(f"  gemv {label} {block} padded {(pn, pk)}, bf16 acc cluster "
              f"{cluster}: max |diff| over f32/bf16 x acc/noacc "
              f"{max(diffs):.3g} (rtol 1e-4, atol 1e-3) ok")

    # every bn the decode spaces offer, bk 16 and 1024, J = 1 at odd pn and
    # both sides of _gemv_kernel's cluster choice (tests/test_torch_cuda.py)
    for (n, k), block, label in (
            ((960, 576), (16, 96), "QKV"), ((960, 576), (32, 192), "QKV"),
            ((960, 576), (48, 48), "QKV"), ((960, 576), (80, 288), "QKV"),
            ((960, 576), (96, 64), "QKV"), ((576, 1536), (128, 384), "down"),
            ((576, 1536), (16, 16), "down"), ((576, 1536), (16, 1024), "down"),
            ((576, 1536), (128, 1024), "down"),
            ((576, 1536), (16, 256), "down"), ((101, 300), (1, 16), "J=1"),
            ((2096, 2304), (16, 64), "131 blocks"),
            ((2112, 2304), (16, 64), "132 blocks"),
            ((16, 4096), (16, 16), "one block"),
            ((16, 1024), (16, 16), "one block, short k"),
            ((32000, 576), (32, 16), "LM head"),
            ((32000, 576), (16, 48), "LM head")):
        check_gemv_block(n, k, block, label)
    check_vmacc(dw1, fixed_library_schedule(dw1, H100).as_dict(),
                "dw1 (library schedule)")
    check_vmacc(dw1, dict(variant="vl_16x128", br=16, bc=16), "dw1")
    odd_dw = W.vmacc(49, 960)
    check_vmacc(odd_dw, dict(variant="vl_min", br=16, bc=80), "odd 49x960")
    check_vmacc(odd_dw, dict(variant="vl_32x128", br=32, bc=128),
                "odd 49x960")

    def at_offset(t, offset):
        """A contiguous copy of ``t`` whose storage starts ``offset``
        elements into a larger buffer (data_ptr() off the 16-byte grain for
        an odd offset)."""
        buf = torch.zeros(t.numel() + offset + 16, dtype=t.dtype,
                          device=t.device)
        view = buf[offset:offset + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    def check_qmm_ragged(dims, blocks, label, offsets=(0, 0)):
        """The unpadded _qmm_kernel at each block, with K split by the
        kernel's rule and over no cluster, exact against the plain version
        on the same unpadded operands (x and w ``offsets`` elements into
        their buffers). One line per shape."""
        x, w, b = device_inputs(W.qmatmul(*dims))
        x, w = at_offset(x, offsets[0]), at_offset(w, offsets[1])
        clusters, widths = set(), set()
        for block in blocks:
            want = qmm_plain.qmatmul_plain(x, w, b, DEFAULT_SCALE, block[2])
            for cap in (None, 1):
                got = qmatmul_ragged(x, w, b, DEFAULT_SCALE, block, cap)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"_qmm_kernel {label} {dims} {block} "
                                       f"cap {cap} offsets {offsets} "
                                       f"disagrees with its plain version")
            p = qmm_ops.plan(*dims, *block, x.data_ptr(), w.data_ptr())
            clusters.add(p.cluster)
            widths.add((p.vx, p.vw))
        print(f"  _qmm_kernel unpadded {label} {dims}: {len(blocks)} blocks "
              f"x (rule, no split), clusters {sorted(clusters)}, copy widths "
              f"(x, w) {sorted(widths)}: exact ok")

    for dims in QMM_SHAPES:
        wl = W.qmatmul(*dims)
        blocks = sorted({concretize(wl, H100, Schedule.fixed(**t)).block
                         for t in space_for(wl, H100).traces()})
        check_qmm_ragged(dims, blocks, "every space block")
    for offsets in ((1, 0), (0, 1), (8, 4), (4, 8)):
        check_qmm_ragged((64, 576, 1536), [(64, 64, 64), (16, 32, 32)],
                         f"offsets {offsets}", offsets)
    check_qmm_ragged((12544, 32, 27), [(32, 32, 32)], "offsets (2, 2)",
                     (2, 2))

    def check_vmacc_ragged(shape, blocks, dtype, offset):
        """The unpadded _vmacc_kernel at each block on arrays ``offset``
        elements into their buffers, against the plain version at 1e-5."""
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        a, b, c = (at_offset(torch.randn(*shape, device="cuda",
                                         generator=gen).to(dtype), offset)
                   for _ in range(3))
        aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, c))
        name = "float32" if dtype == torch.float32 else "bfloat16"
        paths, diffs = set(), []
        for block in blocks:
            got = vmacc_ragged(a, b, c, block)
            torch.cuda.synchronize()
            want = vmacc_plain.vmacc_plain(a, b, c).double()
            diff = (got.double() - want).abs()
            if not bool(torch.all(diff <= 1e-5 + 1e-5 * want.abs())):
                raise RuntimeError(f"_vmacc_kernel {shape} {block} {name} "
                                   f"offset {offset} disagrees with its plain "
                                   f"version")
            diffs.append(float(diff.max()))
            paths.add("vector" if vmacc_ops.plan(*shape, *block, name,
                                                 aligned).v > 1 else "scalar")
        err["_vmacc_kernel"] = max(err["_vmacc_kernel"], max(diffs))
        print(f"  _vmacc_kernel unpadded {shape} {name} offset {offset}, "
              f"{len(blocks)} blocks, {'/'.join(sorted(paths))} path: max "
              f"|diff| {max(diffs):.3g} (rtol 1e-5, atol 1e-5) ok")

    for shape, blocks in (((196, 192), [(16, 128), (32, 16), (16, 48)]),
                          ((49, 960), [(16, 128), (32, 64)]),
                          ((33, 17), [(16, 16), (32, 32)]),
                          ((12544, 32), [(16, 32)])):
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                check_vmacc_ragged(shape, blocks, dtype, offset)

    def check_attention(wl, variant, label, q_scale=1.0):
        params = concretize(wl, H100, Schedule.fixed(variant=variant))
        if not params.valid:
            raise RuntimeError(f"{label}: {params.why_invalid}")
        q, k, v = device_inputs(wl)
        q = q * q_scale
        qp, kp, vp = fa_ops.pad_operands(params, q, k, v)
        got = flash_attention_blocked(qp, kp, vp, params)
        torch.cuda.synchronize()
        d = close(got, fa_plain(qp, kp, vp, params), 2e-3, 2e-3,
                  f"_fa_kernel {label} {variant} {params.block} padded "
                  f"{params.padded_dims[3:]} {wl.dtype}")
        err["_fa_kernel"] = max(err["_fa_kernel"], d)
        # the whole op against the oracle, on the rows that see a key (the
        # others follow the Pallas kernel, not the oracle: ROADMAP)
        lq, lkv = wl.dims[3], wl.dims[4]
        first = max(0, lq - lkv) if "causal" in wl.tags else 0
        out = kernels.build(wl, params)(q, k, v)
        tol = 2e-2 if wl.dtype == "bfloat16" else 2e-3
        close(out[:, :, first:], kernels.reference(wl)(q, k, v)[:, :, first:],
              tol, tol, f"  op {label} vs oracle, rows {first}-{lq - 1}")

    mha = W.attention(1, 2, 2, 64, 64, 64, causal=False)   # BERT-tiny
    gqa = W.attention(1, 9, 3, 64, 64, 64)                 # MobileLLM-125M
    gqa_long = W.attention(1, 9, 3, 2048, 2048, 64)        # at max_seq_len
    mha_long = W.attention(1, 2, 2, 512, 512, 64, causal=False)
    for variant in ("fa_128x128", "fa_16x16"):
        check_attention(mha, variant, "BERT-tiny MHA")
    for variant in ("fa_64x32", "fa_16x64"):
        check_attention(gqa, variant, "MobileLLM GQA causal")
    check_attention(W.attention(1, 9, 3, 64, 64, 64, "bfloat16"), "fa_64x64",
                    "MobileLLM GQA causal")
    ragged = W.attention(1, 2, 1, 17, 33, 8)
    no_key = W.attention(1, 2, 1, 33, 17, 8)   # q rows 0-15 see no key
    for variant in ("fa_16x16", "fa_32x64"):
        check_attention(ragged, variant, "ragged 17x33")
        check_attention(no_key, variant, "no-visible-key 33x17")
    # N8: both models at their published max_seq_len; split KV columns
    # (16 x 64: four warps, 32 x 128: two) and unsplit blocks
    for variant in ("fa_16x64", "fa_32x128", "fa_64x64", "fa_128x128"):
        check_attention(mha_long, variant, "BERT-tiny MHA seq 512")
        check_attention(gqa_long, variant, "MobileLLM GQA causal seq 2048")
    check_attention(W.attention(1, 2, 2, 512, 512, 64, "bfloat16",
                                causal=False), "fa_16x128",
                    "BERT-tiny MHA seq 512")
    # Scores of standard deviation ~4 instead of ~0.25: the running max
    # moves between KV blocks, so the rescale by alpha and the exp path
    # carry the result (and 3xTF32 in QK^T: one TF32 pass would not).
    check_attention(mha, "fa_16x16", "BERT-tiny MHA, sharp scores",
                    Q_SHARP)
    check_attention(gqa, "fa_16x16", "MobileLLM GQA causal, sharp scores",
                    Q_SHARP)
    check_attention(mha_long, "fa_16x64", "BERT-tiny MHA seq 512, sharp "
                    "scores", Q_SHARP)
    for variant in ("fa_16x128", "fa_64x64", "fa_128x128"):
        check_attention(gqa_long, variant,
                        "MobileLLM GQA causal seq 2048, sharp scores",
                        Q_SHARP)

    # ---------------------------------------------------------------- 3 ----
    phase(f"3. main path, one operator: tune W1-W3 ({TRIALS} trials, seed "
          f"{SEED}), database, dispatch")
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
    launches3 = kernels.launch_counts()
    print(f"launches on the one-operator path: {launches3}")

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
        if n_invalid:
            raise RuntimeError(f"{wl.key()}: {n_invalid} INVALID candidates")
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
    for name in SLICE1:
        if launches3[name] == 0:
            raise RuntimeError(f"{name} was not launched on the one-operator "
                               f"path")

    # ---------------------------------------------------------------- 4 ----
    phase(f"4. main path, whole networks: MobileLLM-125M batch-1 decode "
          f"(ensure_tuned, {DECODE_TRIALS} trials per workload) and "
          f"MobileNetV2 int8 (TuningSession, depth 2, {MNV2_TRIALS} trials "
          f"per workload), seed {SEED}")

    def report_networks(sessions):
        """Per network: every unique workload must resolve "tuned" and its
        tuned output equal the plain version's; then the tuned, fixed-
        library and library-call sums and the overlap fraction."""
        for net, res in sessions.items():
            t_lib = 0.0
            for rep in res.reports:
                wl = rep.workload
                params, provenance = kernel_params(wl, H100, database=net_db)
                if provenance != "tuned":
                    raise RuntimeError(f"{wl.key()}: dispatch resolved "
                                       f"{provenance}")
                inputs = runner.inputs(wl)
                got = kernels.build(wl, params)(*inputs)
                # the plain version of the same schedule, on host copies
                want = kernels.build(wl, params, device="cpu")(
                    *(t.cpu() for t in inputs))
                if wl.op == "qmatmul":
                    rtol, atol = 0.0, 0.0
                elif wl.op == "vmacc":
                    rtol, atol = 1e-5, 1e-5
                elif wl.op == "attention":
                    rtol, atol = 2e-3, 2e-3
                elif wl.dtype == "float32":   # f32 matmul and gemv
                    rtol, atol = 1e-4, 1e-3
                else:
                    rtol, atol = 5e-2, 5e-2
                entry = "" if params.accumulate else " noacc"
                close(got.cpu(), want, rtol, atol,
                      f"  tuned x{rep.count} {wl.key()} {params.block}{entry} "
                      f"vs plain")
                lib = baseline_latency(wl)
                t_lib += rep.count * lib
                print(f"    x{rep.count}: tuned {rep.best_latency*1e6:.2f} us, "
                      f"fixed library {rep.fixed_latency*1e6:.2f} us, library "
                      f"call {lib*1e6:.2f} us, {rep.trials} trials")
            print(f"  {net}: {len(res.reports)} unique workloads, "
                  f"{res.total_trials} trials, interleaved {res.interleaved} "
                  f"(depth {res.pipeline_depth}); tuned "
                  f"{res.tuned_latency*1e6:.2f} us, fixed library "
                  f"{res.fixed_latency*1e6:.2f} us, library call "
                  f"{t_lib*1e6:.2f} us (each the sum of count x latency); "
                  f"overlap fraction {res.overlap_fraction:.4f}; wall "
                  f"{res.wall_time_s:.1f} s")

    net_db = TuningDatabase()
    decode = decode_ops(get_config("mobilellm_125m"), 1)
    mnv2 = nets.mobilenetv2("int8")
    kernels.reset_launch_counts()
    sessions = {
        "mobilellm_125m decode": ensure_tuned(
            decode, H100, runner, database=net_db,
            trials_per_workload=DECODE_TRIALS, seed=SEED,
            model="mobilellm_125m-decode-b1"),
    }
    n_mnv2 = len({wl.key() for _, wl in mnv2})
    sessions["mobilenetv2 int8"] = TuningSession(
        H100, runner, database=net_db, pipeline_depth=2).tune_model(
            mnv2, total_trials=MNV2_TRIALS * n_mnv2, seed=SEED,
            model="mobilenetv2-int8")
    launches4 = kernels.launch_counts()
    print(f"launches on the network path: {launches4}")

    report_networks(sessions)
    for name in SLICE2:
        if launches4[name] == 0:
            raise RuntimeError(f"{name} was not launched on the network path")

    phase(f"4b. main path, attention: BERT-tiny and MobileLLM-125M int8 "
          f"prefill at seq 64 (TuningSession, depth 2, {PREFILL_TRIALS} "
          f"trials per workload), seed {SEED}")
    prefill = {"bert_tiny int8 prefill": (nets.bert_tiny("int8"),
                                          "bert_tiny-int8-prefill"),
               "mobilellm_125m int8 prefill": (nets.mobilellm_125m("int8"),
                                               "mobilellm_125m-int8-prefill")}
    kernels.reset_launch_counts()
    sessions3 = {
        net: TuningSession(H100, runner, database=net_db,
                           pipeline_depth=2).tune_model(
            ops, total_trials=PREFILL_TRIALS * len({wl.key()
                                                    for _, wl in ops}),
            seed=SEED, model=model)
        for net, (ops, model) in prefill.items()}
    launches4b = kernels.launch_counts()
    print(f"launches on the attention path: {launches4b}")
    report_networks(sessions3)
    for name in SLICE3:
        if launches4b[name] == 0:
            raise RuntimeError(f"{name} was not launched on the attention "
                               f"path")

    phase(f"4c. main path, bf16 tensor cores: MobileLLM-125M bf16 prefill at "
          f"seq 64 (TuningSession, depth 2, {PREFILL_TRIALS} trials per "
          f"workload), seed {SEED}")
    prefill_bf16 = nets.mobilellm_125m("bfloat16")
    kernels.reset_launch_counts()
    sessions4c = {"mobilellm_125m bf16 prefill": TuningSession(
        H100, runner, database=net_db, pipeline_depth=2).tune_model(
            prefill_bf16, total_trials=PREFILL_TRIALS * len(
                {wl.key() for _, wl in prefill_bf16}),
            seed=SEED, model="mobilellm_125m-bf16-prefill")}
    launches4c = kernels.launch_counts()
    print(f"launches on the bf16 prefill path: {launches4c}")
    report_networks(sessions4c)
    for name in SLICE4:
        if launches4c[name] == 0:
            raise RuntimeError(f"{name} was not launched on the bf16 prefill "
                               f"path")

    phase(f"4d. main path, f32 tensor cores (3xTF32): MobileNetV2 f32 at "
          f"224x224 ({MNV2_TRIALS} trials per workload) and DCGAN f32 "
          f"({DCGAN_TRIALS} trials per workload), TuningSession, depth 2, "
          f"seed {SEED}")
    f32_nets = {"mobilenetv2 f32": (nets.mobilenetv2("float32"), MNV2_TRIALS,
                                    "mobilenetv2-f32"),
                "dcgan f32": (nets.dcgan(), DCGAN_TRIALS, "dcgan-f32")}
    kernels.reset_launch_counts()
    sessions4d = {
        net: TuningSession(H100, runner, database=net_db,
                           pipeline_depth=2).tune_model(
            ops, total_trials=trials * len({wl.key() for _, wl in ops}),
            seed=SEED, model=model)
        for net, (ops, trials, model) in f32_nets.items()}
    launches4d = kernels.launch_counts()
    print(f"launches on the f32 path: {launches4d}")
    report_networks(sessions4d)
    for name in SLICE7:
        if launches4d[name] == 0:
            raise RuntimeError(f"{name} was not launched on the f32 path")

    phase(f"4e. main path, long-context attention: the attention workloads "
          f"of MobileLLM-125M at seq 2048 and BERT-tiny at seq 512 (their "
          f"max_seq_len), TuningSession, depth 2, {PREFILL_TRIALS} trials per "
          f"workload, seed {SEED}")

    def attention_only(ops_list):
        return [(c, wl) for c, wl in ops_list if wl.op == "attention"]

    long_nets = {
        "mobilellm_125m attention seq 2048": (attention_only(
            nets.mobilellm_125m("int8", seq=2048)),
            "mobilellm_125m-attention-2048"),
        "bert_tiny attention seq 512": (attention_only(
            nets.bert_tiny("int8", seq=512)), "bert_tiny-attention-512")}
    kernels.reset_launch_counts()
    sessions4e = {
        net: TuningSession(H100, runner, database=net_db,
                           pipeline_depth=2).tune_model(
            ops, total_trials=PREFILL_TRIALS * len({wl.key()
                                                    for _, wl in ops}),
            seed=SEED, model=model)
        for net, (ops, model) in long_nets.items()}
    launches4e = kernels.launch_counts()
    print(f"launches on the long-context attention path: {launches4e}")
    report_networks(sessions4e)
    for name in SLICE8:
        if launches4e[name] == 0:
            raise RuntimeError(f"{name} was not launched on the long-context "
                               f"attention path")
    launches = {name: launches3[name] + launches4[name] + launches4b[name]
                + launches4c[name] + launches4d[name] + launches4e[name]
                for name in REPLACES}

    # ---------------------------------------------------------------- 5 ----
    phase("5. kernel times at the main paths' shapes")
    timer = CardTimer(repeats=20, warmup=3)

    def measured(wl, history, accumulate=None):
        """The fastest measured schedule of ``history`` ((schedule,
        latency) pairs), optionally of one accumulate choice."""
        hist = [(lat, s) for s, lat in history if lat < float("inf")]
        if accumulate is not None:
            hist = [(lat, s) for lat, s in hist
                    if concretize(wl, H100, s).accumulate == accumulate]
        if not hist:
            raise RuntimeError(f"{wl.key()}: no measured schedule with "
                               f"accumulate={accumulate}")
        return concretize(wl, H100, min(hist, key=lambda r: r[0])[1])

    def best_of(wl, accumulate=None):
        return measured(wl, results[wl.key()][0].history, accumulate)

    def net_best_of(wl, accumulate=None):
        return measured(wl, [(Schedule.from_json(r["schedule"]),
                              r["latency_s"])
                             for r in net_db.history(wl, H100.name)],
                        accumulate)

    rows = []
    # The timer's floor: the least any launch measures here (L2 flushed,
    # events around one launch)
    one = torch.zeros(1, device="cuda")
    xs = torch.ones(1, 16, device="cuda")
    ws = torch.ones(16, 16, device="cuda")
    print(f"  timer floor: one-element fill_ "
          f"{timer(lambda t: t.fill_(1.0), (one,))*1e6:.2f} us, 16x16 gemv "
          f"(16, 16) {timer(gemv_blocked, (xs, ws, (16, 16)))*1e6:.2f} us")

    def row(name, wl, params, label):
        x = runner.inputs(wl)
        if wl.op == "attention":
            args = (*fa_ops.pad_operands(params, *x), params)
            kern, plain_fn = flash_attention_blocked, fa_plain
            bound, by = bound_ms(args[:3], kern(*args),
                                 attention_visible_ops(wl), wl.dtype)
        elif wl.op == "vmacc":
            # the unpadded entry, as the wrapper calls it
            args = (*x, params.block)
            kern = vmacc_ragged
            plain_fn = lambda *a: vmacc_plain.vmacc_plain(*a[:3])  # noqa: E731
            bound, by = bound_ms(x, kern(*args), 2.0 * math.prod(wl.dims),
                                 wl.dtype)
        elif wl.op == "gemv":
            pn, pk = params.padded_dims
            xp, wp = pad2(x[0], 1, pk).contiguous(), pad2(x[1], pk, pn).contiguous()
            args = (xp, wp, params.block, params.accumulate)
            kern = gemv_blocked
            plain_fn = lambda *a: gemv_plain.gemv_plain(  # noqa: E731
                a[0], a[1], params.block[1])
            bound, by = bound_ms((xp, wp), kern(*args), 2.0 * pn * pk,
                                 wl.dtype)
        elif wl.op == "qmatmul":
            # the unpadded entry, as the wrapper calls it
            args = (*x, DEFAULT_SCALE, params.block)
            kern, plain_fn = qmatmul_ragged, (
                lambda *a: qmm_plain.qmatmul_plain(*a[:4], params.block[2]))
            bound, by = bound_ms(x, kern(*args), 2.0 * math.prod(wl.dims),
                                 "int8")
        else:
            pm, pn, pk = params.padded_dims
            xp = pad2(x[0], pm, pk).contiguous()
            wp = pad2(x[1], pk, pn).contiguous()
            args = (xp, wp, params.block, params.order, params.accumulate)
            kern, plain_fn = matmul_blocked, (
                lambda *a: mm_plain.matmul_plain(a[0], a[1], params.block[2]))
            bound, by = bound_ms((xp, wp), kern(*args), 2.0 * pm * pn * pk,
                                 wl.dtype)
        tf32 = {}
        if wl.op == "matmul" and wl.dtype == "float32":
            tf32["bound_3xtf32_ms"] = 3 * 2.0 * pm * pn * pk / PEAK_TF32 * 1e3
        if wl.op == "attention" and wl.dtype == "float32":
            tf32["bound_3xtf32_ms"] = (3 * attention_visible_ops(wl)
                                       / PEAK_TF32 * 1e3)
        r = {"name": name, "route": "cuda", "source": SOURCE[name],
             "replaces": REPLACES[name],
             "launches": launches[name], "max_abs_err": err[name],
             "ms": timer(kern, args) * 1e3,
             "plain_ms": timer(plain_fn, args) * 1e3,
             "bound_ms": bound, "bound_by": by,
             "library_ms": timer(kernels.baseline(wl), x) * 1e3,
             "workload": label, "block": list(params.block), **tf32}
        rows.append(r)
        extra = (f"; 3xTF32 at the TF32 peak {tf32['bound_3xtf32_ms']*1e3:.3f}"
                 f" us" if tf32 else "")
        print(f"  {name} {label} block {params.block}: kernel "
              f"{r['ms']*1e3:.2f} us, plain {r['plain_ms']*1e3:.2f} us, "
              f"library {r['library_ms']*1e3:.2f} us, bound "
              f"{r['bound_ms']*1e3:.3f} us ({by}){extra}")
        return r

    acc3 = row("_acc_kernel", wl3, best_of(wl3, accumulate=True), "W3")
    noacc3 = row("_noacc_kernel", wl3, best_of(wl3, accumulate=False), "W3")
    try:
        lm_params = net_best_of(lm_head_mm, accumulate=True)
    except RuntimeError as exc:   # the session measured no acc LM head
        lm_params = concretize(lm_head_mm, H100, Schedule.fixed(
            variant="mxu_64", bm=64, bn=64, bk=64, order="mnk",
            accumulate=True))
        print(f"  {exc}; timing the block {lm_params.block}")
    row("_acc_kernel", lm_head_mm, lm_params,
        "MobileLLM bf16 prefill LM head 64x32000x576")
    row("_qmm_kernel", wl1, best_of(wl1), "W1")
    qmm2 = row("_qmm_kernel", wl2, best_of(wl2), "W2")
    n4_proj, n2_fc = W.qmatmul(64, 576, 1536), W.qmatmul(1, 1000, 1280)
    n4_row = row("_qmm_kernel", n4_proj, net_best_of(n4_proj),
                 "MobileLLM int8 prefill 64x576x1536")
    row("_qmm_kernel", n2_fc, net_best_of(n2_fc),
        "MobileNetV2 classifier 1x1000x1280")
    # _qmm_kernel at 64 x 576 x 1536 with K split over a cluster by its rule
    # and over none (qmatmul_launch_capped): what the split buys
    x = runner.inputs(n4_proj)
    for block in sorted({tuple(n4_row["block"]), (64, 64, 64)}):
        c = qmm_ops.plan(*n4_proj.dims, *block).cluster
        t_c = timer(qmatmul_ragged, (*x, DEFAULT_SCALE, block))
        t_1 = timer(qmatmul_ragged, (*x, DEFAULT_SCALE, block, 1))
        print(f"  _qmm_kernel 64x576x1536 {block}: {c}-block clusters "
              f"{t_c*1e6:.2f} us, no cluster {t_1*1e6:.2f} us")
    # f32 on the tensor cores (3xTF32), library call torch.matmul f32 with
    # TF32 off: W3 at the blocks the CUDA-core kernel was timed at, then
    # the f32 networks' shapes at their tuned accumulating blocks
    acc3_f32 = row("_acc_kernel", wl3_f32, concretize(
        wl3_f32, H100, fixed_library_schedule(wl3_f32, H100)), "W3 f32")
    noacc3_f32 = row("_noacc_kernel", wl3_f32,
                     concretize(wl3_f32, H100, noacc), "W3 f32")

    def f32_best(wl):
        """The f32 sessions' fastest accumulating block, or the fixed
        library's (accumulating) where they measured none."""
        try:
            return net_best_of(wl, accumulate=True)
        except RuntimeError as exc:
            print(f"  {exc}; timing the fixed library block")
            return concretize(wl, H100, fixed_library_schedule(wl, H100))

    costly = max((r for r in sessions4d["mobilenetv2 f32"].reports
                  if r.workload.op == "matmul"),
                 key=lambda r: r.count * r.best_latency).workload
    n6_row = row("_acc_kernel", costly, f32_best(costly),
                 f"MobileNetV2 f32 costliest matmul "
                 f"{'x'.join(map(str, costly.dims))}")
    n7_mm = W.matmul(1024, 64, 512, "float32")
    n7_row = row("_acc_kernel", n7_mm, f32_best(n7_mm),
                 "DCGAN f32 1024x64x512")
    # the f32 _acc_kernel at DCGAN's 64 x 256 x 2048 (32 k steps of 64) and
    # at W3 with K split over a cluster by its rule and over none: what the
    # split buys
    n7_long = W.matmul(64, 256, 2048, "float32")
    for wl, blocks in ((n7_long, {f32_best(n7_long).block, (64, 64, 64)}),
                       (wl3_f32, {(64, 64, 32), (64, 64, 64)})):
        x = runner.inputs(wl)
        for block in sorted(blocks):
            pm, pn, pk = (math.ceil(d / b) * b for d, b in zip(wl.dims, block))
            xp = pad2(x[0], pm, pk).contiguous()
            wp = pad2(x[1], pk, pn).contiguous()
            c = mm_ops.plan(pm, pn, pk, *block, True).cluster
            t_c = timer(matmul_blocked, (xp, wp, block))
            t_1 = timer(matmul_blocked, (xp, wp, block, "mnk", True, 1))
            print(f"  _acc_kernel f32 {'x'.join(map(str, wl.dims))} {block}: "
                  f"{c}-block clusters {t_c*1e6:.2f} us, no cluster "
                  f"{t_1*1e6:.2f} us")
    def gemv_best(wl, accumulate):
        """The decode session's fastest block of one entry, or the 128 x 64
        block where the session measured none of that entry."""
        try:
            return net_best_of(wl, accumulate=accumulate)
        except RuntimeError as exc:
            params = concretize(wl, H100, Schedule.fixed(
                variant="vl_128", bn=128, bk=64, accumulate=accumulate))
            print(f"  {exc}; timing the block {params.block}")
            return params

    gemv_acc = row("_gemv_kernel", lm_head, gemv_best(lm_head, True),
                   "LM head")
    gemv_noacc = row("_gemv_noacc_kernel", lm_head,
                     gemv_best(lm_head, False), "LM head")
    for wl, label in ((down_proj, "down projection 576x1536"),
                      (up_proj, "up projection 1536x576")):
        for name, acc in (("_gemv_kernel", True),
                          ("_gemv_noacc_kernel", False)):
            row(name, wl, gemv_best(wl, acc), label)
    # _gemv_kernel at the down projection with K split over a cluster by
    # its rule and over none (gemv_launch_capped): what the cluster buys
    x = runner.inputs(down_proj)
    for block in sorted({gemv_best(down_proj, True).block, (16, 256)}):
        pn, pk = (math.ceil(d / b) * b for d, b in zip(down_proj.dims, block))
        xp = pad2(x[0], 1, pk).contiguous()
        wp = pad2(x[1], pk, pn).contiguous()
        c = gemv_ops.plan(pn, pk, *block, "bfloat16", True).cluster
        t_c = timer(gemv_blocked, (xp, wp, block, True))
        t_1 = timer(gemv_blocked, (xp, wp, block, True, 1))
        print(f"  _gemv_kernel down projection {block}: {c}-block clusters "
              f"{t_c*1e6:.2f} us, no cluster {t_1*1e6:.2f} us")
    vmacc_row = row("_vmacc_kernel", dw1, net_best_of(dw1), "dw1")
    n2_dw = W.vmacc(196, 192)
    row("_vmacc_kernel", n2_dw, net_best_of(n2_dw),
        "MobileNetV2 14x14 dw 196x192")

    def device_kernels(fn, inputs):
        """Names of the card's kernels that one call of ``fn`` launches
        (torch.profiler, after a first call that builds and loads)."""
        fn(*inputs)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(*inputs)
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    for wl in (n2_dw, W.qmatmul(12544, 32, 27)):
        params = net_best_of(wl)
        names_seen = device_kernels(kernels.build(wl, params),
                                    runner.inputs(wl))
        print(f"  one kernels.build({wl.key()}, {params.block}) call: "
              f"{len(names_seen)} kernel(s) on the card {names_seen}")
        if len(names_seen) != 1:
            raise RuntimeError(f"{wl.key()}: {len(names_seen)} kernels in "
                               f"one call, not 1")
    def sdpa_backend(wl, x):
        """Which SDPA backend ran: the card's kernels in one call."""
        seen = " ".join(device_kernels(kernels.baseline(wl), x)).lower()
        if "flash" in seen:
            return "flash"
        if "fmha" in seen or "efficient" in seen or "cutlass" in seen:
            return "efficient"
        return "math"

    fa_row = row("_fa_kernel", gqa, net_best_of(gqa),
                 "MobileLLM prefill seq 64")
    mha_long_row = row("_fa_kernel", mha_long, net_best_of(mha_long),
                       "BERT-tiny seq 512")
    fa_long_row = row("_fa_kernel", gqa_long, net_best_of(gqa_long),
                      "MobileLLM prefill seq 2048")
    for r, wl in ((fa_row, gqa), (mha_long_row, mha_long),
                  (fa_long_row, gqa_long)):
        r["sdpa_backend"] = sdpa_backend(wl, runner.inputs(wl))
        print(f"  _fa_kernel {r['workload']}: SDPA ran its "
              f"{r['sdpa_backend']} backend")
    ladder = {v: runner.run(gqa_long, Schedule.fixed(variant=v))
              for v in space_for(gqa_long, H100)["variant"]}
    print("  seq 2048 ladder (us, the op as dispatch builds it): "
          + ", ".join(f"{v} {t*1e6:.1f}" for v, t in ladder.items()))
    print("  (_fa_kernel bounds count the operations of the visible "
          "(query, key) pairs only)")
    print("rows " + json.dumps(rows))
    print(card_line)
    strip = ("workload", "block", "bound_3xtf32_ms", "sdpa_backend")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in strip}
                                  for r in (acc3, noacc3, qmm2, gemv_acc,
                                            gemv_noacc, vmacc_row, fa_row,
                                            fa_long_row, acc3_f32,
                                            noacc3_f32, n6_row, n7_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
