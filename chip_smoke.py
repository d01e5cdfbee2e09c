#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

The main path is the paper's tuning loop: a workload -> its design-space
program -> concretized kernel parameters -> a CUDA kernel built from
``src/repro_torch/kernels/csrc`` -> timed on the card by ``CudaRunner`` ->
``tune`` (sampler, evolution, cost model) -> ``TuningDatabase`` ->
``dispatch.kernel_params``. These paths drive it, each at the published
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

- the serving path (phase 6): MobileLLM-125M unreduced through the
  port's ``Server``, whose dispatch misses feed a ``TrafficLog`` that a
  ``ContinuousTuner`` tunes on the card, at batch 1 and batch 4;

- long-context attention (N8): the attention workloads of MobileLLM-125M
  at its max_seq_len 2048 (``attention(1, 9, 3, 2048, 2048, 64)`` f32
  causal GQA, x30) and BERT-tiny at its 512 (``attention(1, 2, 2, 512, 512,
  64)`` f32 MHA, x2), taken from ``repro_torch.nets.mobilellm_125m("int8",
  seq=2048)`` and ``bert_tiny("int8", seq=512)``, through
  ``TuningSession`` at pipeline depth 2;

- the measurement farm (phase 7, N10): MobileLLM-125M's batch-1 decode
  step tuned by ``TuningSession`` at pipeline depth 2 on a ``BoardFarm`` of
  one ``LocalBoard`` (the card), every candidate built and timed by
  ``CudaRunner`` in a worker process of its own on the card;

- the other model families (phase 8, N11): Qwen1.5-MoE-A2.7B unreduced
  (15.15 B parameters, 60.6 GB of f32 master weights drawn on the card)
  through ``Server`` and one ``ContinuousTuner`` cycle at batch 1 and 4,
  as phase 6 serves MobileLLM-125M (the gemv kernels at its expert widths,
  the bf16 matmul kernels at four rows); Mamba2-780M, RecurrentGemma-2B and
  Whisper-tiny (1500 stub frames) at their published widths;

- training (phase 9, T1): Granite-3-2B unreduced (2.53 B parameters, f32
  masters, bf16 compute) through the train launcher's ``Trainer`` under a
  ``Supervisor``: autograd through every layer, AdamW in place, the
  launcher's batch 8 at sequence 128 of ``SyntheticLM``. No kernel of the
  port runs in it: the reference's training path holds no Pallas kernel;

- sharded training (phase 10, T1-mesh): the same model, seed, data and
  steps through the launcher's ``--mesh host``: ``jit_train_step`` on a
  (1, 1) ("data", "model") NCCL mesh, the state and batches as DTensors,
  the layers' activation-sharding hooks set (no kernel of the port either);

- the dry run (phase 11, D1): cells of the production meshes traced on
  the host with meta states and a fake process group, and phase 9's step
  counted on the card against its trace (no kernel: the dry run launches
  none).

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
     the bytes and operations of the function's real, unpadded operands
     and output;
  6. the serving path: MobileLLM-125M unreduced (30 layers, d_model 576,
     9 query and 3 KV heads, bf16 compute on f32 master weights from a
     seeded generator) through ``Server`` with 64-token prompts and 32
     generated tokens. At batch 1 and at batch 4: a cold round must resolve
     {"fixed": 151} and leave the five decode shapes in the ``TrafficLog``,
     one ``ContinuousTuner.tune_once()`` on ``CudaRunner`` (16 trials a
     shape) tunes them (the gemv kernels at batch 1, the bf16 matmul
     kernels at four rows at batch 4), the next round must resolve
     {"tuned": 151}, each tuned schedule's output on the card must equal
     its plain version's on the CPU (bf16, 5e-2), and of two rounds with
     ``build_kernels`` the second must build nothing; then batch-1 decode
     on the tuned database with the layers' views from one ``unbind`` per
     stack against the parent's per-layer indexing, alternated three times
     each (decode ms a step); then the tuner in the background (start, generate,
     wait_idle, generate: "tuned"); then (a) in f32 with TF32 off, greedy
     decode equal to the argmax of the full forward wherever its top-1/
     top-2 margin exceeds 1e-3, (b) the f32 prefill and first 8 decode
     steps' logits on the card equal to the CPU's within 1e-3, and
     ``python -m repro_torch.launch.serve --continuous-tune --rounds 2``
     exiting 0. Its launches join the kernels line's;
  7. the measurement farm: (a) N10, the decode step's five gemv shapes at
     full width, 16 trials a shape (seed 0), through a farm of one
     ``LocalBoard`` on the card; every shape must resolve "tuned" with 0
     worker restarts and no board death, each best schedule built in this
     process must equal its plain version (1e-4 / 1e-3), and each best
     latency re-timed by this process's ``CudaRunner`` must agree with the
     farm's within 20 %; the tuned, fixed-library and library-call sums
     beside phase 4's N1, the farm's counters and utilization; the
     worker's launch counts (read there: they are per process) join the
     kernels line's; (b) one ``MeasurePool`` worker on the card runs W1 at
     its tuned block, a device-side assert, W1, a spin past the deadline,
     W1: the outcomes must be ok, crash, ok, timeout, ok with 2 restarts,
     the three W1 latencies within 20 %, and this process's context must
     still measure; then a farm of one ``LocalBoard`` (no retries) takes a
     batch with a faulting candidate, which must be ``INVALID`` while the
     batch completes; (c) ``python examples/quickstart_torch.py`` must
     exit 0;
  8. the other model families: (a) Qwen1.5-MoE-A2.7B at its published
     widths (24 layers, d_model 2048, 16 heads of 128, 60 experts padded
     to 64 of width 1408, top-4, 4 shared, vocab 151936 untied, bf16
     compute), its weight casts timed, through ``serve_rounds`` at batch 1
     and 4 as phase 6 ({"fixed": 121} cold, {"tuned": 121} after one
     cycle, no build in the steady state, tuned outputs against plain),
     one decode step profiled; (b) in f32, greedy decode equal to the
     forward's argmax at a capacity factor that drops nothing (reported at
     the published one, with the forward's drop count), and layer 0 on the
     card against a CPU copy: the routing compared exactly (a flip must be
     a tie of the router's logits) and the output within 1e-3 on the
     tokens routed alike; (c) Mamba2-780M (no dispatch layer: its
     decode_ops hold zero-width gemvs), RecurrentGemma-2B and Whisper-tiny
     (each op through dispatch, every resolved kernel built and launched)
     at their published widths: a served round and a profiled step, f32
     greedy decode against the forward, and reduced() prefill and decode
     logits on the card within 1e-3 of the CPU's. The gemv kernels (batch
     1) and the bf16 matmul kernels (batch 4) are timed at Qwen1.5-MoE's
     five decode shapes on its tuned blocks (rows on the ``kernels`` line),
     and phase 8's launches join the line's;
  9. training, with under 1 GB of the card allocated at its start: (a)
     Granite-3-2B unreduced, 20 steps (lr TRAIN_LR), every loss and grad
     norm finite and the mean loss of steps 15-19 below step 0's; the step
     ms (median of steps 3-19), tokens/s, 6 N tokens / step against the
     989 TFLOP/s bf16 peak, peak memory against the 16 bytes a parameter
     of masters, grads and moments; one step profiled (card ms, idle
     share, operations, the optimizer update's card ms), once with the
     stacked layers taken apart by ``unbind`` and once with the parent's
     per-layer indexing; one step at remat "full" beside one at "none"
     (peak memory, step ms); (b) MobileLLM-125M unreduced in f32, two
     steps on the card and on the CPU from one set of weights: each loss
     within 1e-4, the first grad norm within 1e-4 relative; (c) the same
     model with int8-compressed gradients, 12 steps with checkpoints every
     5 under build/ and a failure injected at step 8: one restart, 12
     steps, steps 10-11's losses an uninterrupted run's at rtol 1e-5; (d)
     every architecture at reduced(), f32, one step on the card and on the
     CPU: loss within 1e-4, grad norm within 1e-4 relative;
  10. sharded training, with under 1 GB of the card allocated at its
     start: Granite-3-2B unreduced through the launcher's ``--mesh host``
     (``train_mesh``, ``make_trainer`` on the mesh, a ``Supervisor``), 20
     steps as phase 9's (a); the mesh must be (1, 1) ("data", "model") on
     NCCL and the parameters DTensors; each loss within 1e-5 of phase 9's
     at the same step; the step ms (median of steps 3-19), tokens/s, peak
     memory, one step profiled (card ms, idle share, operations); after
     it no process group may remain; then ``--mesh production`` must fail
     in ``make_production_mesh`` for lack of ranks (256 wanted, 1 here),
     again leaving no process group;
  11. the dry run (D1), in subprocesses (their fake process groups never
     meet phase 10's): (a) granite_3_2b/train_4k and
     qwen2_moe_a2_7b/train_4k on 16x16 and qwen2_moe_a2_7b/decode_32k on
     2x16x16 through ``python -m repro_torch.launch.dryrun`` (per-device
     flops, bytes, collective bytes by op, peak estimate against the
     card's 85.02 GB, dominant term, roofline fraction, trace time; a
     failed cell, or a train cell whose peak estimate is over the card's
     memory, fails the phase); (b)
     phase 9's Granite step (remat none), run once more on the card under
     ``op_analysis.analyze`` before its state is released, must count
     exactly the flops and bytes, and no collective, that the same step
     traced on a fake (1, 1) mesh with a meta state counts; both beside
     6 N D, phase 9's profiled card time and max_memory_allocated;
  12. the examples, each in a subprocess on the card at short settings:
     ``examples/train_lm_torch.py --steps 20`` (MobileLLM-125M at full
     width), ``examples/serve_lm_torch.py --continuous-tune`` (cold
     ``fixed``, one tuner cycle on ``CudaRunner``, then ``tuned``) and
     ``examples/tune_workload_torch.py --trials 4`` (BERT-tiny int8 as one
     ``TuningSession``); their key lines printed, an exit code other than 0
     fails the phase.
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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# phase 7's pool tasks (tests/_torch_pool_tasks.py): spawned workers import
# them by name, so they live in a module, not in this script
sys.path.append(os.path.join(ROOT, "tests"))

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


# Phase 6: MobileLLM-125M unreduced through the serving path. Prompts of the
# paper's sequence length, 32 generated tokens, 16 tuning trials a shape.
SERVE_PROMPT, SERVE_GEN, SERVE_TRIALS = 64, 32, 16


def serve_report(label: str, batch: int, res) -> None:
    steps = SERVE_GEN - 1
    mix = " ".join(f"{k}={v}" for k, v in sorted(res.dispatch.items())) \
        if res.dispatch is not None else "none"
    print(f"  {label}: prefill {res.prefill_s*1e3:.2f} ms; decode "
          f"{res.decode_s*1e3/steps:.3f} ms per step; "
          f"{batch*steps/res.decode_s:.1f} tokens/s; dispatch {mix}")


def expect_mix(res, mix, label: str) -> None:
    if res.dispatch != mix:
        raise RuntimeError(f"{label}: dispatch {res.dispatch}, want {mix}")


def serve_rounds(bundle, params, prompts, max_len: int, runner, close,
                 launch_needed, extra_batch=None):
    """A model served through dispatch at ``prompts``' batch: a cold round
    (every op "fixed", the step's shapes in the TrafficLog), one
    ``ContinuousTuner.tune_once()`` on ``runner`` ({SERVE_TRIALS} trials a
    shape), a tuned round (every op "tuned"), and two rounds with
    ``build_kernels`` (the second must build nothing); each tuned
    schedule's output on the card against its plain version on the CPU
    (bf16, 5e-2). Returns the rounds' launch counts (zeroed just before
    the cold round and read after the last), the tuner's cycle result, its
    database and the library-call sum (count x latency) of the shapes."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import (H100, ContinuousTuner, TrafficLog,
                                  TuningDatabase, baseline_latency,
                                  build_cache_stats, kernel_params)
    from repro_torch.runtime.serve_loop import Server, decode_ops

    batch = prompts.shape[0]
    ops = decode_ops(bundle.cfg, batch)
    total = sum(count for count, _ in ops)
    demand = {}
    for count, wl in ops:
        demand[wl.key()] = demand.get(wl.key(), 0) + count
    # warm-up (cuBLAS handles, the allocator) on a dispatch-less server
    Server(bundle, params, max_len=max_len).generate(prompts, 2, extra_batch)
    db, log = TuningDatabase(), TrafficLog()
    server = Server(bundle, params, max_len=max_len, hw=H100,
                    serve_ops=ops, traffic=log, database=db)
    kernels.reset_launch_counts()
    res0 = server.generate(prompts, SERVE_GEN, extra_batch)
    serve_report(f"batch {batch} round 0 (cold)", batch, res0)
    expect_mix(res0, {"fixed": total}, f"batch {batch} round 0")
    logged = {e.workload.key(): e.hits for e in log.hottest()}
    print(f"    traffic log: {logged}")
    if logged != demand:
        raise RuntimeError(f"batch {batch}: the log holds {logged}, "
                           f"want {demand}")
    tuner = ContinuousTuner(log, H100, runner=runner, database=db,
                            trials_per_shape=SERVE_TRIALS,
                            max_shapes_per_cycle=len(ops), seed=SEED)
    result = tuner.tune_once()
    print(f"    tuner: {tuner.cycles} cycle(s), {tuner.shapes_tuned} "
          f"shapes, {result.total_trials} trials on {runner.name}, "
          f"wall {result.wall_time_s:.2f} s, overlap fraction "
          f"{result.overlap_fraction:.4f}")
    library = 0.0
    for rep in result.reports:
        params_t = db.best(rep.workload, H100.name)
        lib = baseline_latency(rep.workload)
        library += rep.count * lib
        print(f"    x{rep.count} {rep.workload.key()}: tuned "
              f"{rep.best_latency*1e6:.2f} us, fixed library "
              f"{rep.fixed_latency*1e6:.2f} us, library call "
              f"{lib*1e6:.2f} us, {rep.trials} trials, "
              f"{params_t[0].as_dict()}")
    print(f"    sum of count x latency: tuned "
          f"{result.tuned_latency*1e6:.2f} us, fixed library "
          f"{result.fixed_latency*1e6:.2f} us, library call "
          f"{library*1e6:.2f} us")
    res1 = server.generate(prompts, SERVE_GEN, extra_batch)
    serve_report(f"batch {batch} round 1 (tuned)", batch, res1)
    expect_mix(res1, {"tuned": total}, f"batch {batch} round 1")
    server.build_kernels = True
    before = build_cache_stats()
    res2 = server.generate(prompts, SERVE_GEN, extra_batch)
    mid = build_cache_stats()
    res3 = server.generate(prompts, SERVE_GEN, extra_batch)
    after = build_cache_stats()
    launches = kernels.launch_counts()
    new_builds = after["misses"] - mid["misses"]
    print(f"    build_kernels rounds: {mid['misses'] - before['misses']}"
          f" build(s) in round 2 ({mid['hits'] - before['hits']} hits), "
          f"{new_builds} in round 3 ({after['hits'] - mid['hits']} "
          f"hits)")
    for rnd, res in ((2, res2), (3, res3)):
        expect_mix(res, {"tuned": total}, f"batch {batch} round {rnd}")
    if new_builds:
        raise RuntimeError(f"batch {batch}: the steady state built "
                           f"{new_builds} kernels")
    print(f"    launches: {launches}")
    for name in launch_needed:
        if launches[name] == 0:
            raise RuntimeError(f"{name} was not launched on the batch "
                               f"{batch} serving path")
    # each tuned schedule's output on the card against its plain version
    # on host copies (after the counts are read: these launches are not
    # the path's)
    for rep in result.reports:
        wl = rep.workload
        params_t, provenance = kernel_params(wl, H100, database=db)
        if provenance != "tuned":
            raise RuntimeError(f"{wl.key()}: dispatch resolved "
                               f"{provenance}")
        inputs = runner.inputs(wl)
        got = kernels.build(wl, params_t)(*inputs)
        want = kernels.build(wl, params_t, device="cpu")(
            *(t.cpu() for t in inputs))
        entry = "" if params_t.accumulate else " noacc"
        close(got.cpu(), want, 5e-2, 5e-2,
              f"    tuned x{rep.count} {wl.key()} {params_t.block}{entry}"
              f" vs plain")
        del inputs, got, want
    torch.cuda.synchronize()
    return launches, result, db, library


def greedy_against_forward(bundle32, params, prompts, max_len: int,
                           label: str, extra_batch=None, n_gen=SERVE_GEN,
                           strict: bool = True):
    """f32 greedy decode through ``Server`` against the argmax of the
    teacher-forced forward over the generated tokens, wherever the
    forward's top-1/top-2 margin exceeds 1e-3; raises on a disagreement
    when ``strict``. Returns the generation."""
    import torch

    from repro_torch.runtime.serve_loop import Server

    out = Server(bundle32, params, max_len=max_len).generate(
        prompts, n_gen, extra_batch)
    batch = dict(extra_batch or {}, tokens=out.tokens[:, :-1])
    with torch.no_grad():
        full = bundle32.forward(params, batch)
    s = prompts.shape[1]
    top2 = full[:, s - 1:].float().topk(2, dim=-1)
    margin = (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()
    greedy = top2.indices[..., 0].cpu().numpy()
    gen = out.tokens[:, s:]
    sure = margin > 1e-3
    wrong = int(((gen != greedy) & sure).sum())
    print(f"  {label}: {int(sure.sum())} of {gen.size} tokens have a "
          f"top-1/top-2 margin above 1e-3, {wrong} of them differ; "
          f"{int((gen != greedy).sum())} differ in all (least margin "
          f"{margin.min():.3g})")
    if wrong and strict:
        raise RuntimeError(f"{label}: f32 greedy decode disagrees with the "
                           f"forward")
    return out


def profile_decode_step(bundle, params, prompts, max_len: int,
                        extra_batch=None) -> None:
    """One decode step at ``prompts``' batch under torch.profiler: the
    card's operations, their summed time, and the step's wall time
    unprofiled."""
    import torch

    batch = dict(extra_batch or {}, tokens=prompts)
    logits, cache = bundle.prefill_fn(params, batch, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    pos = prompts.shape[1]
    bundle.decode_fn(params, cache, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.decode_fn(params, cache, tok, pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        bundle.decode_fn(params, cache, tok, pos)
        torch.cuda.synchronize()
    ops_on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in ops_on_card) / 1e6
    print(f"  one batch-{prompts.shape[0]} decode step: {len(ops_on_card)} "
          f"operations on the card, {busy * 1e3:.3f} ms of device time in a "
          f"{wall * 1e3:.3f} ms step (unprofiled): the card idles "
          f"{1 - busy / wall:.1%} of it")


def _indexed_layers(tree) -> list[dict]:
    """The parent's layer views: ``param[i]`` per layer (``layer_slice``),
    so that in a backward each layer writes a zero tensor the size of the
    whole stack."""
    from repro_torch.models import transformer as T

    n = T.tree_tensors(tree)[0].shape[0]
    return [T.layer_slice(tree, i) for i in range(n)]


def compare_layer_views(bundle, params, prompts, max_len: int, ops,
                        db) -> None:
    """Batch-1 decode after tuning (a Server on the tuned database ``db``)
    with each stack taken apart by one ``unbind`` per step and with the
    parent's ``param[i]`` per layer patched in, alternated unbind, indexed,
    indexed, unbind, unbind, indexed: each round's decode ms a step and
    each way's median."""
    import contextlib
    import statistics
    from unittest import mock

    from repro_torch.core import H100
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve_loop import Server

    server = Server(bundle, params, max_len=max_len, hw=H100, serve_ops=ops,
                    database=db)
    server.generate(prompts, 2)
    times = {"unbind": [], "indexed": []}
    for way in ("unbind", "indexed", "indexed", "unbind", "unbind",
                "indexed"):
        with contextlib.ExitStack() as stack:
            if way == "indexed":
                stack.enter_context(
                    mock.patch.object(T, "unbind_layers", _indexed_layers))
            res = server.generate(prompts, SERVE_GEN)
        times[way].append(res.decode_s * 1e3 / (SERVE_GEN - 1))
    print("  layer views at decode (batch 1, tuned): "
          + "; ".join(f"{way} " + " ".join(f"{t:.3f}" for t in ts)
                      + f" ms a step (median {statistics.median(ts):.3f})"
                      for way, ts in times.items()))


def serving_phase(runner, card_line: str, close) -> dict[str, int]:
    """Phase 6: the port's serving path at MobileLLM-125M's full width —
    ``Server`` resolving each decode step's workloads through dispatch,
    misses into a ``TrafficLog``, ``ContinuousTuner`` cycles on
    ``CudaRunner``, the database flipping later rounds to "tuned" — at
    batch 1 (the gemv kernels) and batch 4 (the bf16 matmul kernels at four
    rows), then in the background, then the f32 and card-against-CPU
    checks and the launcher. Returns the launch counts of its serving
    loops (each zeroed just before and read just after)."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import H100, ContinuousTuner, TrafficLog, \
        TuningDatabase
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.serve_loop import Server, decode_ops

    cfg = get_config("mobilellm_125m")  # unreduced
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings,
              cfg.dtype)
    if widths != (30, 576, 9, 3, 64, 1536, 32000, True, "bfloat16"):
        raise RuntimeError(f"mobilellm_125m is not at its published widths: "
                           f"{widths}")
    bundle = build(cfg, remat="none")
    params = bundle.init(torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {n_params} parameters, f32 master weights "
          f"{n_params * 4 / 2**20:.1f} MiB on {params.embedding.device}; "
          f"compute {cfg.dtype}; prompts {SERVE_PROMPT}, {SERVE_GEN} "
          f"generated tokens ({SERVE_GEN - 1} decode steps after the "
          f"prefill's token)")
    print(f"  card: {card_line}")
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    # every projection casts its f32 master weight to the compute dtype, as
    # the reference's .astype(x.dtype) does: bytes read and written per step
    from repro_torch.core.runner import CardTimer

    mats = [p for p in params.parameters() if p.dim() >= 2]
    per_layer = [m for m in mats if m.dim() == 3]
    cast_bytes = sum(m.numel() for m in mats) * (4 + 2)
    cast_s = CardTimer(repeats=5, warmup=1)(
        lambda *ws: [w.to(torch.bfloat16) for w in ws], tuple(mats))
    print(f"  f32 -> bf16 weight casts per forward or decode step: "
          f"{len(mats)} weight tensors ({len(per_layer)} stacked over the "
          f"layers, cast a layer's slice at a time), {cast_bytes / 1e6:.1f} "
          f"MB read and written, at least "
          f"{cast_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate; "
          f"casting them whole measures {cast_s * 1e3:.3f} ms")

    def prompts_of(batch):
        return bundle.make_batch(SEED, ShapeSpec("serve", SERVE_PROMPT,
                                                 batch, "decode"),
                                 train=False)["tokens"]

    launches, dbs = {}, {}
    for batch, needed in ((1, ("_gemv_kernel", "_gemv_noacc_kernel")),
                          (4, ("_acc_kernel",))):
        counts, _, dbs[batch], _ = serve_rounds(
            bundle, params, prompts_of(batch), max_len, runner, close,
            needed)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    profile_decode_step(bundle, params, prompts_of(1), max_len)
    ops = decode_ops(cfg, 1)
    compare_layer_views(bundle, params, prompts_of(1), max_len, ops, dbs[1])

    # the background tuner, as launch/serve.py drives it: start, generate,
    # wait_idle, generate, stop (fresh database, warm build cache)
    total = sum(count for count, _ in ops)
    db, log = TuningDatabase(), TrafficLog()
    server = Server(bundle, params, max_len=max_len, hw=H100,
                    serve_ops=ops, traffic=log, database=db)
    tuner = ContinuousTuner(log, H100, runner=runner, database=db,
                            trials_per_shape=SERVE_TRIALS,
                            max_shapes_per_cycle=len(ops), seed=SEED,
                            poll_interval_s=0.05).start()
    kernels.reset_launch_counts()
    try:
        res_a = server.generate(prompts_of(1), SERVE_GEN)
        serve_report("background round 0", 1, res_a)
        expect_mix(res_a, {"fixed": total}, "background round 0")
        if not tuner.wait_idle(timeout=300.0):
            raise RuntimeError("the background tuner did not finish")
        res_b = server.generate(prompts_of(1), SERVE_GEN)
        serve_report("background round 1", 1, res_b)
        expect_mix(res_b, {"tuned": total}, "background round 1")
    finally:
        tuner.stop()
    for name, n in kernels.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    print(f"    background tuner: {tuner.cycles} cycle(s), "
          f"{tuner.shapes_tuned} shapes")

    # (a) f32, TF32 off: greedy decode equals the argmax of the full forward
    # wherever the forward's top-1/top-2 margin exceeds 1e-3
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    bundle32 = build(cfg32, remat="none")
    out = greedy_against_forward(bundle32, params, prompts_of(4), max_len,
                                 "(a) f32 greedy decode vs the forward's "
                                 "argmax")

    # (b) the card against the CPU: f32 prefill logits and the first 8 decode
    # steps' logits, on the same tokens
    bundle_cpu = build(cfg32, remat="none", device="cpu")
    params_cpu = bundle_cpu.init(torch.Generator().manual_seed(SEED))
    params_cpu.load_state_dict(params.state_dict())
    tokens = out.tokens[:1]
    prompt = {"tokens": tokens[:, :SERVE_PROMPT]}
    got, cache = bundle32.prefill_fn(params, prompt, max_len)
    want, cache_cpu = bundle_cpu.prefill_fn(params_cpu, prompt, max_len)
    close(got.cpu(), want, 1e-3, 1e-3, "(b) f32 prefill logits, card vs CPU")
    worst = 0.0
    for i in range(8):
        pos = SERVE_PROMPT + i
        tok = tokens[:, pos:pos + 1]
        got, cache = bundle32.decode_fn(params, cache, tok, pos)
        want, cache_cpu = bundle_cpu.decode_fn(params_cpu, cache_cpu, tok, pos)
        worst = max(worst, close(got.cpu(), want, 1e-3, 1e-3,
                                 f"(b) f32 decode step {i} logits, card vs "
                                 f"CPU"))

    # the launcher, in its own process at its reduced default
    db_path = os.path.join(ROOT, "build", "serve_smoke_db.json")
    if os.path.exists(db_path):
        os.remove(db_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--continuous-tune", "--rounds", "2", "--tune-db", db_path]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=400)
    print(f"  launcher ({' '.join(cmd[1:])}): exit code {proc.returncode}")
    for line in proc.stdout.splitlines():
        print("    " + line)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("the serving launcher failed")
    return launches


# Phase 7: the measurement farm. N10 tunes 16 trials a shape (as phase 6);
# the fault sequence's candidate deadline, and a spin well past it.
FARM_TRIALS, FAULT_TIMEOUT_S, SPIN_S = 16, 6.0, 20.0


def farm_phase(runner, close, n1_tuned_s: float, w1_best) -> dict[str, int]:
    """Phase 7: the measurement farm on the card. (a) N10: MobileLLM-125M's
    batch-1 decode tuned by ``TuningSession(pipeline_depth=2)`` through a
    ``BoardFarm`` of one ``LocalBoard`` (every candidate built and timed in
    a worker process on the card); (b) fault isolation: a device-side
    assert and a spin past the deadline each cost one worker respawn, in a
    ``MeasurePool`` and through a farm; (c) ``examples/quickstart_torch.py``
    in its own process. Returns the launch counts read from (a)'s worker
    (zeroed there just before the session, read just after)."""
    import torch

    import _torch_pool_tasks
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (H100, BoardFarm, LocalBoard, MeasurePool,
                                  Schedule, TuningDatabase, TuningSession,
                                  baseline_latency, kernel_params)
    from repro_torch.core import workload as W
    from repro_torch.core.measure_pool import _initializer
    from repro_torch.runtime.serve_loop import decode_ops

    inf = float("inf")

    # ---- (a) N10 through a farm of one LocalBoard ------------------------
    decode = decode_ops(get_config("mobilellm_125m"), 1)
    n_unique = len({wl.key() for _, wl in decode})
    # the board's task is the default measurement plus reading and zeroing
    # the worker's launch counts (they are per process); it concretizes
    # every schedule, so the farm's static screen stays on as for the
    # default task
    board = LocalBoard("h100-0", H100, device=0, repeats=runner.repeats,
                       warmup=runner.warmup,
                       task=_torch_pool_tasks.measure_or_counts)
    board.static_screenable = True
    farm = BoardFarm([board], straggler_timeout_s=600.0)
    db = TuningDatabase()
    try:
        t0 = time.perf_counter()
        reset = board._ensure_pool().run_many(["reset_launch_counts"])[0]
        if not reset.ok:
            raise RuntimeError(f"the farm's worker did not start: "
                               f"{reset.status} {reset.error}")
        print(f"  worker start-up (spawn, torch, CUDA context, kernels' "
              f"build check): {time.perf_counter() - t0:.2f} s")
        res = TuningSession(H100, farm, database=db, pipeline_depth=2,
                            min_trials=FARM_TRIALS).tune_model(
            decode, total_trials=FARM_TRIALS * n_unique, seed=SEED,
            model="mobilellm_125m-decode-b1-farm")
        counts = board._ensure_pool().run_many(["launch_counts"])[0]
        restarts = board._pool.restarts
        summary = farm.farm_summary()
    finally:
        farm.close()
    if not counts.ok:
        raise RuntimeError(f"reading the worker's launch counts: "
                           f"{counts.status} {counts.error}")
    launches = counts.value
    print(f"  launches in the farm's worker: {launches}")
    stats = summary["boards"]["h100-0"]
    print(f"  farm: dispatched {stats['dispatched']}, completed "
          f"{stats['completed']}, requeued {stats['requeued']}, deaths "
          f"{stats['deaths']}, respawns {stats['respawns']}, utilization "
          f"{stats['utilization']:.4f} (busy {stats['busy_s']:.2f} s of "
          f"{summary['measure_wall_s']:.2f} s active); static_rejected "
          f"{summary['static_rejected']}; pool restarts {restarts}")
    t_lib = 0.0
    for rep in res.reports:
        wl = rep.workload
        params, provenance = kernel_params(wl, H100, database=db)
        if provenance != "tuned" or not rep.best_latency < inf:
            raise RuntimeError(f"{wl.key()}: not tuned through the farm "
                               f"({provenance}, {rep.best_latency})")
        inputs = runner.inputs(wl)
        got = kernels.build(wl, params)(*inputs)
        want = kernels.build(wl, params, device="cpu")(
            *(t.cpu() for t in inputs))
        entry = "" if params.accumulate else " noacc"
        close(got.cpu(), want, 1e-4, 1e-3,
              f"  farm-tuned x{rep.count} {wl.key()} {params.block}{entry} "
              f"built in the parent vs plain")
        again = runner.run(wl, rep.best_schedule)
        lib = baseline_latency(wl)
        t_lib += rep.count * lib
        ratio = max(again, rep.best_latency) / min(again, rep.best_latency)
        print(f"    x{rep.count}: farm {rep.best_latency*1e6:.2f} us, parent "
              f"re-timed {again*1e6:.2f} us (x{ratio:.3f}), fixed library "
              f"{rep.fixed_latency*1e6:.2f} us, library call "
              f"{lib*1e6:.2f} us, {rep.trials} trials")
        if ratio > 1.2:
            raise RuntimeError(f"{wl.key()}: the farm's latency and the "
                               f"parent's differ by more than 20 %")
    print(f"  N10 mobilellm_125m decode through the farm: "
          f"{len(res.reports)} unique workloads, {res.total_trials} trials, "
          f"interleaved {res.interleaved} (depth {res.pipeline_depth}, "
          f"multi-queue {res.multi_queue}); tuned "
          f"{res.tuned_latency*1e6:.2f} us, fixed library "
          f"{res.fixed_latency*1e6:.2f} us, library call {t_lib*1e6:.2f} us "
          f"(each the sum of count x latency); phase 4's in-process N1 tuned "
          f"{n1_tuned_s*1e6:.2f} us; overlap fraction "
          f"{res.overlap_fraction:.4f}; wall {res.wall_time_s:.2f} s")
    if len(res.reports) != n_unique or res.total_trials != \
            FARM_TRIALS * n_unique:
        raise RuntimeError("N10: not every shape was tuned its trials")
    if restarts or stats["deaths"] or stats["requeued"]:
        raise RuntimeError("N10: the farm lost a worker or a board")
    if not res.multi_queue or res.board_stats is None:
        raise RuntimeError("N10: the session did not reach the farm's native "
                           "submission path and counters")
    for name in ("_gemv_kernel", "_gemv_noacc_kernel"):
        if not launches.get(name):
            raise RuntimeError(f"{name} was not launched in the farm's worker")

    # ---- (b) fault isolation on the card ---------------------------------
    wl1 = W.qmatmul(3136, 64, 576)
    cand = ("measure", (H100, wl1, w1_best, runner.repeats, runner.warmup))
    tasks = [cand, ("device_assert", None), cand, ("spin", SPIN_S), cand]
    pool = MeasurePool(_torch_pool_tasks.card_task, workers=1,
                       timeout_s=FAULT_TIMEOUT_S,
                       initializer=_initializer(
                           H100, _torch_pool_tasks.card_task),
                       devices=[0])
    with pool:
        t0 = time.perf_counter()
        pool.run_many([("reset_launch_counts", None)])
        t_start = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = pool.run_many(tasks)
        wall = time.perf_counter() - t0
        restarts = pool.restarts
        tail = pool.run_many([("launch_counts", None)])[0]
    statuses = [o.status for o in out]
    respawn_s = (wall - sum(o.elapsed_s for o in out)) / max(restarts, 1)
    print(f"  (b) one worker on the card: {statuses}, restarts {restarts}; "
          f"start-up {t_start:.2f} s, respawn {respawn_s:.2f} s each (the "
          f"sequence's wall {wall:.2f} s less its tasks' time, over the "
          f"restarts); the fault: {out[1].error.splitlines()[0]}; the spin: "
          f"{out[3].error}; the last worker's launches {tail.value}")
    if statuses != ["ok", "crash", "ok", "timeout", "ok"] or restarts != 2:
        raise RuntimeError(f"fault isolation: {statuses}, {restarts} "
                           f"restarts; want ok, crash, ok, timeout, ok and 2")
    lats = [out[i].value for i in (0, 2, 4)]
    print(f"    W1 {w1_best.as_dict()} in the worker: "
          + ", ".join(f"{x*1e6:.2f}" for x in lats) + " us")
    if max(lats) > 1.2 * min(lats):
        raise RuntimeError("fault isolation: the real candidate's latencies "
                           "differ by more than 20 %")
    mine = runner.run(wl1, w1_best)
    print(f"    the parent's CudaRunner afterwards: {mine*1e6:.2f} us")
    if not 0 < mine < inf:
        raise RuntimeError("the parent's context did not survive")

    # the same through a BoardFarm of one LocalBoard, in the shape of the
    # reference's test_candidate_that_kills_every_board_goes_invalid_after_
    # retries: the faulting candidate is INVALID, the batch completes
    fault = Schedule.fixed(variant="device_assert")
    batch = [w1_best, fault, w1_best]
    board = LocalBoard("h100-0", H100, device=0, repeats=runner.repeats,
                       warmup=runner.warmup,
                       candidate_timeout_s=FAULT_TIMEOUT_S,
                       task=_torch_pool_tasks.measure_or_fault)
    with BoardFarm([board], max_retries=0,
                   straggler_timeout_s=600.0) as farm:
        got = farm.run_batch(wl1, batch)
        restarts = board._pool.restarts
        summary = farm.farm_summary()
    print(f"  (b) through a farm of one LocalBoard: latencies "
          + ", ".join(f"{x*1e6:.2f}" if x < inf else "INVALID" for x in got)
          + f" us; pool restarts {restarts}; board healthy "
          f"{board.healthy}; invalid_after_retries "
          f"{summary['invalid_after_retries']}")
    if got[1] != inf or not all(0 < x < inf for x in (got[0], got[2])) \
            or restarts != 1 or not board.healthy:
        raise RuntimeError("the farm did not isolate the faulting candidate")

    # ---- (c) the example ---------------------------------------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, os.path.join("examples", "quickstart_torch.py")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    print(f"  (c) python examples/quickstart_torch.py: exit code "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines()[-9:]:
        print("    " + line)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("examples/quickstart_torch.py failed")
    torch.cuda.synchronize()
    return launches


# Phase 8: the other model families. Qwen1.5-MoE-A2.7B unreduced through
# the serving path as phase 6 serves MobileLLM-125M (the same prompts,
# tokens and trials); then Mamba2-780M, RecurrentGemma-2B and Whisper-tiny
# (1500 stub frames) at their published widths, full depth.
QWEN_WIDTHS = (24, 2048, 16, 16, 128, 60, 64, 1408, 4, 4, 151936, False,
               "bfloat16")


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    return fn(node)


def moe_layer_against_cpu(params, cfg32, tokens, close) -> None:
    """(b) Layer 0 of the MoE model at full width (attention, router, the
    64 padded experts, the shared experts), f32, on the card and on a CPU
    copy of its weights, on the prompt's embeddings: the routing compared
    exactly first (each token's experts in order and which assignments
    capacity keeps), every flip printed and required to be a tie of the
    router's logits within f32 error; then the layer's output within 1e-3
    on every token whose routing agrees."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    lp = T.layer_slice(params["layers"], 0)
    n_bytes = [0]

    def to_cpu(t):
        n_bytes[0] += t.numel() * t.element_size()
        return t.detach().cpu()

    lp_cpu = _tree_map(to_cpu, lp)

    def parts(x, lp):
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(x.shape[0], s)
        h = L.rms_norm(x, lp["ln1"], cfg32.norm_eps)
        attn_out, _ = L.attention(h, lp["attn"], cfg32, positions, -1)
        x2 = x + attn_out
        h2 = L.rms_norm(x2, lp["ln2"], cfg32.norm_eps)
        sel, _, slot, cap = moe.route(h2, lp["router"], cfg32)
        keep = (slot < moe.padded_experts(cfg32) * cap).reshape(sel.shape)
        logits = (h2 @ lp["router"]).float()
        return sel, keep, logits, x2 + moe.moe_ffn(h2, lp, cfg32)

    with torch.no_grad():
        x = L.embed(torch.as_tensor(tokens, device=params.embedding.device),
                    params, cfg32, torch.float32)
        card = [t.cpu() for t in parts(x, lp)]
        cpu = parts(x.cpu(), lp_cpu)
    sel_c, keep_c, _, out_c = card
    sel_h, keep_h, logits_h, out_h = cpu
    sel_flip = (sel_c != sel_h).any(-1)
    keep_flip = (keep_c != keep_h).any(-1)
    agree = ~(sel_flip | keep_flip)
    print(f"  (b) one full-width MoE layer ({n_bytes[0] / 1e9:.2f} GB of f32 "
          f"weights copied to the CPU), {sel_c.shape[1]} tokens x top-"
          f"{sel_c.shape[2]}: expert choice differs on "
          f"{int(sel_flip.sum())} token(s), capacity keep on "
          f"{int(keep_flip.sum())}, {int(keep_h.numel() - keep_h.sum())} "
          f"assignment(s) dropped on the CPU and "
          f"{int(keep_c.numel() - keep_c.sum())} on the card")
    for b, t in sel_flip.nonzero().tolist():
        gap = float((logits_h[b, t].gather(0, sel_h[b, t])
                     - logits_h[b, t].gather(0, sel_c[b, t])).abs().max())
        print(f"    flip at token {t}: card {sel_c[b, t].tolist()}, CPU "
              f"{sel_h[b, t].tolist()}, CPU router-logit gap {gap:.3g}")
        if gap > 1e-4:
            raise RuntimeError(f"token {t}: the card and the CPU route to "
                               f"different experts on untied logits")
    close(out_c[agree], out_h[agree], 1e-3, 1e-3,
          f"(b) MoE layer 0 output on the {int(agree.sum())} tokens routed "
          f"alike, card vs CPU")


def reduced_card_vs_cpu(arch: str, close) -> None:
    """(c) ``arch`` at reduced(), f32, on the card and on the CPU from the
    same weights: prefill and three decode steps' logits within 1e-3."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model_zoo import build

    cfg = get_config(arch).reduced()
    on_card, on_cpu = build(cfg), build(cfg, device="cpu")
    params = on_cpu.init(torch.Generator().manual_seed(SEED))
    params_card = on_card.init(torch.Generator().manual_seed(SEED))
    params_card.load_state_dict(params.state_dict())
    batch = on_cpu.make_batch(SEED, ShapeSpec("p", 19, 2, "decode"),
                              train=False)
    prompt = dict(batch, tokens=batch["tokens"][:, :16])
    got, cache = on_card.prefill_fn(params_card, prompt, 24)
    want, cache_cpu = on_cpu.prefill_fn(params, prompt, 24)
    worst = close(got.cpu(), want, 1e-3, 1e-3,
                  f"    {cfg.name} prefill logits, card vs CPU")
    for pos in range(16, 19):
        tok = batch["tokens"][:, pos:pos + 1]
        got, cache = on_card.decode_fn(params_card, cache, tok, pos)
        want, cache_cpu = on_cpu.decode_fn(params, cache_cpu, tok, pos)
        worst = max(worst, close(got.cpu(), want, 1e-3, 1e-3,
                                 f"    {cfg.name} decode@{pos} logits, card "
                                 f"vs CPU"))


def moe_cast_report(params, cfg) -> None:
    """Every projection casts its f32 weight to bf16 per layer, the stacked
    experts whole (moe.py: the reference's .astype(x.dtype)), as does the
    untied LM head: the bytes a decode step reads and writes for it, and
    its time, one layer's slices at a time."""
    import torch

    from repro_torch.core.runner import CardTimer

    stacked = [p for p in params.parameters() if p.dim() >= 3]
    cast_bytes = (sum(m.numel() for m in stacked)
                  + params.lm_head.numel()) * (4 + 2)
    timer = CardTimer(repeats=5, warmup=1)
    t_layer = timer(lambda *ws: [w.to(torch.bfloat16) for w in ws],
                    tuple(m[0] for m in stacked))
    t_head = timer(lambda w: w.to(torch.bfloat16), (params.lm_head,))
    print(f"  f32 -> bf16 weight casts per decode step: "
          f"{cast_bytes / 1e9:.1f} GB read and written, at least "
          f"{cast_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate; "
          f"measured {t_layer * 1e3:.3f} ms a layer x {cfg.n_layers} + "
          f"{t_head * 1e3:.3f} ms the LM head = "
          f"{(t_layer * cfg.n_layers + t_head) * 1e3:.3f} ms")


def moe_f32_checks(cfg, params, prompts4, prompts1, max_len: int,
                   close) -> None:
    """(b) of phase 8 on the MoE model's parameters, in f32 (TF32 off):
    greedy decode against the forward, and one layer against the CPU."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build

    # The forward over 95 tokens and prefill + decode differ where capacity
    # drops an assignment (capacity is per sequence length: 8 slots an
    # expert for the forward, none dropped in a one-token step), so decode
    # consistency is asserted at a capacity factor that drops nothing
    # (E / top_k: capacity = sequence length), as the reference's reduced()
    # configs do; at the published factor it is reported with the
    # forward's drop count.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    no_drop = dataclasses.replace(
        cfg32, capacity_factor=moe.padded_experts(cfg) / cfg.top_k)
    greedy_against_forward(build(no_drop, remat="none"), params, prompts4,
                           max_len, f"(b) f32 greedy decode vs the forward's "
                           f"argmax, capacity factor "
                           f"{no_drop.capacity_factor} (no drop)")
    real_route, drops = moe.route, []

    def counting_route(x, router, c):
        sel, gates, slot, cap = real_route(x, router, c)
        if x.shape[1] > 1:  # the forward's (and the prefill's) layers
            drops.append((int((slot == moe.padded_experts(c) * cap).sum()),
                          slot.numel()))
        return sel, gates, slot, cap

    moe.route = counting_route
    try:
        greedy_against_forward(build(cfg32, remat="none"), params, prompts4,
                               max_len, f"(b) the same at the published "
                               f"capacity factor {cfg32.capacity_factor}",
                               strict=False)
    finally:
        moe.route = real_route
    fwd = drops[-cfg.n_layers:]
    print(f"    the published-capacity forward dropped "
          f"{sum(d for d, _ in fwd)} of {sum(n for _, n in fwd)} "
          f"assignments over its {cfg.n_layers} layers")
    moe_layer_against_cpu(params, cfg32, prompts1, close)


def families_phase(runner, card_line: str, close):
    """Phase 8: (a) Qwen1.5-MoE-A2.7B unreduced through ``Server``, the
    dispatch miss log and one ``ContinuousTuner`` cycle at batch 1 and 4,
    as phase 6; its weight casts and one profiled decode step. (b) f32
    checks at full width: greedy decode against the forward, one MoE layer
    against the CPU. (c) Mamba2-780M (no dispatch layer: its decode_ops
    hold zero-width gemvs), RecurrentGemma-2B and Whisper-tiny (through
    dispatch, each resolved kernel built and launched) at their published
    widths: prefill and decode on the card, f32 greedy against the forward,
    reduced() against the CPU. Returns the launch counts of its serving
    loops and the batch-1 and batch-4 tuners' databases and reports."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import H100, TrafficLog, TuningDatabase
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.serve_loop import Server, decode_ops

    max_len = SERVE_PROMPT + SERVE_GEN + 1
    cfg = get_config("qwen2_moe_a2_7b")  # unreduced
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, cfg.n_experts, moe.padded_experts(cfg),
              cfg.moe_d_ff, cfg.top_k, cfg.n_shared_experts, cfg.vocab_size,
              cfg.tie_embeddings, cfg.dtype)
    if widths != QWEN_WIDTHS:
        raise RuntimeError(f"qwen2_moe_a2_7b is not at its published "
                           f"widths: {widths}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    print(f"  card: {card_line}; {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated before the model, {total_mem / 1e9:.2f} GB in all")
    t0 = time.perf_counter()
    bundle = build(cfg, remat="none")
    # drawn on the card: a host generator would stage 60 GB on the host
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {n_params} parameters, f32 master weights "
          f"{n_params * 4 / 1e9:.2f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; compute {cfg.dtype}; "
          f"{cfg.n_experts} experts padded to {moe.padded_experts(cfg)} of "
          f"width {cfg.moe_d_ff}, top-{cfg.top_k}, {cfg.n_shared_experts} "
          f"shared; prompts {SERVE_PROMPT}, {SERVE_GEN} generated tokens")
    moe_cast_report(params, cfg)

    def prompts_of(batch, c=cfg):
        return build(c, device="cpu").make_batch(
            SEED, ShapeSpec("serve", SERVE_PROMPT, batch, "decode"),
            train=False)

    launches, sums, tuners = {}, {}, {}
    for batch, needed in ((1, ("_gemv_kernel", "_gemv_noacc_kernel")),
                          (4, ("_acc_kernel",))):
        counts, result, db, library = serve_rounds(
            bundle, params, prompts_of(batch)["tokens"], max_len, runner,
            close, needed)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        sums[batch] = (result.tuned_latency, result.fixed_latency, library)
        tuners[batch] = (db, result.reports)
    profile_decode_step(bundle, params, prompts_of(1)["tokens"], max_len)
    print(f"  peak memory so far {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB of {total_mem / 1e9:.2f} GB")

    moe_f32_checks(cfg, params, prompts_of(4)["tokens"],
                   prompts_of(1)["tokens"], max_len, close)
    print(f"  peak memory of (a) and (b) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
          f"{total_mem / 1e9:.2f} GB")
    del params, bundle
    torch.cuda.empty_cache()
    print(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after "
          f"the MoE model is freed")

    # (c) the other families at their published widths
    for arch, via_dispatch in (("mamba2_780m", False),
                               ("recurrentgemma_2b", True),
                               ("whisper_tiny", True)):
        fcfg = get_config(arch)  # unreduced
        fbundle = build(fcfg, remat="none")
        fparams = fbundle.init(torch.Generator(device="cuda").manual_seed(
            SEED))
        n = sum(p.numel() for p in fparams.parameters())
        batch = prompts_of(1, fcfg)
        prompts = batch.pop("tokens")
        extra = batch or None
        ops = decode_ops(fcfg, 1) if via_dispatch else None
        server = Server(fbundle, fparams, max_len=max_len,
                        hw=H100 if via_dispatch else None, serve_ops=ops,
                        traffic=TrafficLog() if via_dispatch else None,
                        database=TuningDatabase(),
                        build_kernels=via_dispatch)
        # warm-up (cuBLAS handles, the allocator) on a dispatch-less server
        Server(fbundle, fparams, max_len=max_len).generate(prompts, 2, extra)
        kernels.reset_launch_counts()
        res = server.generate(prompts, SERVE_GEN, extra)
        counts = kernels.launch_counts()
        print(f"  (c) {fcfg.name}: {n} parameters ({n * 4 / 1e9:.2f} GB "
              f"f32), {fcfg.n_layers} layers, d_model {fcfg.d_model}"
              + (f", {fcfg.encoder_seq} frames" if extra else "")
              + f"; launches {counts}")
        serve_report(f"{fcfg.name} batch 1", 1, res)
        if via_dispatch:
            total = sum(c for c, _ in ops)
            expect_mix(res, {"fixed": total}, fcfg.name)
            for name in ("_gemv_kernel",):
                if counts[name] == 0:
                    raise RuntimeError(f"{name} was not launched on "
                                       f"{fcfg.name}'s dispatch path")
            for name, c in counts.items():
                launches[name] = launches.get(name, 0) + c
        elif res.dispatch is not None:
            raise RuntimeError(f"{fcfg.name} was served through dispatch")
        profile_decode_step(fbundle, fparams, prompts, max_len, extra)
        greedy_against_forward(
            build(dataclasses.replace(fcfg, dtype="float32"), remat="none"),
            fparams, prompts, max_len,
            f"    {fcfg.name} f32 greedy decode vs the forward's argmax",
            extra)
        reduced_card_vs_cpu(arch, close)
        del fparams, fbundle, server
        torch.cuda.empty_cache()
    print(f"  phase 8 peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB of {total_mem / 1e9:.2f} GB")
    for batch, (tuned, fixed, library) in sums.items():
        print(f"  {cfg.name} batch {batch} tuner cycle (count x latency over "
              f"the five shapes): tuned {tuned * 1e6:.2f} us, fixed library "
              f"{fixed * 1e6:.2f} us, library call {library * 1e6:.2f} us")
    return launches, tuners


# Phase 9: training (T1). Granite-3-2B unreduced through the train
# launcher's objects at its defaults (batch 8, seq 128, SyntheticLM seed 0,
# remat none) but the lr: the launcher's 3e-3 (its reduced configs') makes
# the full-width model's loss rise; 3e-4 makes it fall steadily. Then card
# against CPU and the restart at MobileLLM-125M's width, and one step of
# every family at reduced().
TRAIN_STEPS, TRAIN_LR = 20, 3e-4
GRANITE_WIDTHS = (40, 2048, 32, 8, 64, 8192, 49155, True, "bfloat16")
# H100 SXM dense bf16 peak (the published figure PEAK_OPS holds)
BF16_PEAK = PEAK_OPS["bfloat16"]


def profile_train_step(trainer, label: str) -> dict:
    """One more step of ``trainer`` under torch.profiler: the card's
    operations, their summed time, the optimizer update's card time (the
    ``adamw.update`` range), against the step's wall time unprofiled (the
    step before it)."""
    import torch

    trainer.run(1)
    wall = trainer.records[-1].wall_s
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.run(1)
        torch.cuda.synchronize()
    events = prof.events()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "adamw.update"]
    busy = sum(e.device_time for e in on_card) / 1e6
    opt = [e.device_time_total for e in events if e.name == "adamw.update"
           and e.device_type == torch.autograd.DeviceType.CPU]
    opt_ms = max(opt) / 1e3 if opt else float("nan")
    print(f"  {label}: {len(on_card)} operations on the card, "
          f"{busy * 1e3:.3f} ms of device time in a {wall * 1e3:.3f} ms "
          f"step (unprofiled): the card idles {1 - busy / wall:.1%} of it; "
          f"the optimizer update {opt_ms:.3f} ms of device time")
    return {"ops": len(on_card), "card_ms": busy * 1e3,
            "wall_ms": wall * 1e3, "opt_ms": opt_ms}


def granite_training(card_line: str) -> list[float]:
    """(a) Granite-3-2B unreduced: TRAIN_STEPS steps through a Trainer
    under a Supervisor, finite and falling; step time, tokens/s, model
    TFLOP/s against the bf16 peak, peak memory against the reckoning; one
    step profiled with the layers taken apart by unbind and one with the
    parent's per-layer indexing; one step with remat="full". Returns the
    TRAIN_STEPS losses."""
    import statistics
    from unittest import mock

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime.supervisor import Supervisor
    from repro_torch.runtime.train_loop import make_train_step

    args = launch_train.parse_args([
        "--arch", "granite_3_2b", "--no-reduced", "--steps",
        str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--seed", str(SEED)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = launch_train.make_trainer(args)
    torch.cuda.synchronize()
    cfg = trainer.bundle.cfg
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings,
              cfg.dtype)
    if widths != GRANITE_WIDTHS:
        raise RuntimeError(f"granite_3_2b is not at its published widths: "
                           f"{widths}")
    n = sum(p.numel() for p in trainer.state["params"].parameters())
    tokens = args.batch * args.seq_len
    print(f"  (a) {cfg.name}: {n} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; f32 masters, {cfg.dtype} "
          f"compute, remat {args.remat}; batch {args.batch} x seq "
          f"{args.seq_len} = {tokens} tokens a step from SyntheticLM(seed="
          f"{args.seed}); lr {args.lr}, warmup {trainer.opt_cfg.warmup_steps},"
          f" cosine over {trainer.opt_cfg.total_steps} steps, weight decay "
          f"{trainer.opt_cfg.weight_decay}")
    print(f"  memory reckoning: 16 bytes a parameter (masters, grads, m, v) "
          f"{16 * n / 1e9:.2f} GB, the bf16 casts {2 * n / 1e9:.2f} GB, "
          f"then activations")
    report = Supervisor(trainer).run(TRAIN_STEPS)
    recs = trainer.records
    losses = [r.loss for r in recs]
    gnorms = [r.metrics["grad_norm"] for r in recs]
    print("  losses " + " ".join(f"{x:.4f}" for x in losses))
    print("  grad norms " + " ".join(f"{x:.3f}" for x in gnorms))
    if report.completed_steps != TRAIN_STEPS or report.restarts:
        raise RuntimeError(f"granite training: {report}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise RuntimeError("granite training: a loss or grad norm is not "
                           "finite")
    late = statistics.fmean(losses[15:20])
    if not late < losses[0]:
        raise RuntimeError(f"granite training: the loss did not fall "
                           f"(step 0 {losses[0]:.4f}, steps 15-19 "
                           f"{late:.4f})")
    step_s = statistics.median(r.wall_s for r in recs[3:TRAIN_STEPS])
    peak = torch.cuda.max_memory_allocated()
    print(f"  loss step 0 {losses[0]:.4f}, mean of steps 15-19 {late:.4f}; "
          f"step {step_s * 1e3:.2f} ms (median of steps 3-19), "
          f"{tokens / step_s:.0f} tokens/s, 6 N tokens / step "
          f"{6 * n * tokens / step_s / 1e12:.1f} TFLOP/s = "
          f"{6 * n * tokens / step_s / BF16_PEAK:.1%} of the "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16 peak ({card_line}); peak "
          f"memory {peak / 1e9:.2f} GB against the 16 N = "
          f"{16 * n / 1e9:.2f} GB reckoning")

    unbound = profile_train_step(trainer, "one step, layers unbound")
    with mock.patch.object(T, "unbind_layers", _indexed_layers):
        indexed = profile_train_step(trainer, "one step, the parent's "
                                              "per-layer indexing")
    print(f"  layer_slice: unbind {unbound['card_ms']:.3f} ms of card time, "
          f"{unbound['ops']} operations, {unbound['wall_ms']:.3f} ms wall; "
          f"per-layer indexing {indexed['card_ms']:.3f} ms, "
          f"{indexed['ops']} operations, {indexed['wall_ms']:.3f} ms wall")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(1)
    none_peak, none_ms = torch.cuda.max_memory_allocated(), \
        trainer.records[-1].wall_s * 1e3
    calibration = dict(analyze_card_step(trainer), card_ms=unbound["card_ms"],
                       opt_ms=unbound["opt_ms"], peak=peak)
    trainer.train_step = make_train_step(build(cfg, remat="full"),
                                         trainer.opt_cfg)
    # the first checkpointed step in a process pays torch's one-time import
    # of its checkpoint machinery (seconds); the second is the one reported
    trainer.run(1)
    first_ms = trainer.records[-1].wall_s * 1e3
    torch.cuda.reset_peak_memory_stats()
    trainer.run(1)
    full_peak, full_ms = torch.cuda.max_memory_allocated(), \
        trainer.records[-1].wall_s * 1e3
    if not all(math.isfinite(r.loss) for r in trainer.records):
        raise RuntimeError("granite training: a later step is not finite")
    print(f"  remat none: peak {none_peak / 1e9:.2f} GB, step "
          f"{none_ms:.2f} ms; remat full: peak {full_peak / 1e9:.2f} GB, "
          f"step {full_ms:.2f} ms (its first step {first_ms:.2f} ms)")
    del trainer
    torch.cuda.empty_cache()
    return losses, calibration


def analyze_card_step(trainer) -> dict:
    """One more step of ``trainer`` (remat none) under
    ``op_analysis.analyze``, its batch put on the card first: the counts
    phase 11 (b) holds against the dry run's trace of the same step, and
    the step's ``max_memory_allocated``."""
    import torch

    from repro_torch.launch import op_analysis

    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in trainer.data.batch_at(trainer.step).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = op_analysis.analyze(trainer.train_step, trainer.state, batch)
    torch.cuda.synchronize()
    return {"analysis": summary.to_json(), "memory": summary.memory,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "analyze_s": time.perf_counter() - t0}


def _card_and_cpu(cfg, seed: int):
    """Bundles of ``cfg`` on the card and the CPU and one set of weights
    (drawn on the CPU) carried to both with ``from_numpy_params``."""
    import torch

    from repro_torch.models.model_zoo import build, from_numpy_params
    from repro_torch.optim.tree import nest

    cpu = build(cfg, remat="none", device="cpu")
    drawn = cpu.init(torch.Generator().manual_seed(seed))
    tree = nest({name: p.detach().numpy()
                 for name, p in drawn.named_parameters()})
    return (build(cfg, remat="none"), from_numpy_params(cfg, tree, "cuda"),
            cpu, from_numpy_params(cfg, tree, "cpu"))


def mobilellm_card_vs_cpu(close) -> None:
    """(b) MobileLLM-125M unreduced in f32 (TF32 off): two train steps on
    the card and two on the CPU from one set of weights and one
    SyntheticLM stream: each loss within 1e-4, the first step's grad norm
    within 1e-4 relative, the largest gradient difference printed."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import make_train_step

    cfg = dataclasses.replace(get_config("mobilellm_125m"), dtype="float32")
    on_card, p_card, on_cpu, p_cpu = _card_and_cpu(cfg, SEED)
    data = SyntheticLM(cfg.vocab_size, 64, 2, seed=SEED)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                      weight_decay=0.0)
    batch = data.batch_at(0)
    grads = [torch.autograd.grad(b.loss_fn(p, batch), list(p.parameters()))
             for b, p in ((on_card, p_card), (on_cpu, p_cpu))]
    worst = max(float((g.cpu() - h).abs().max())
                for g, h in zip(*grads))
    scale = max(float(h.abs().max()) for h in grads[1])
    print(f"  (b) {cfg.name} f32: largest gradient difference, card vs "
          f"CPU, {worst:.3g} (largest gradient {scale:.3g})")
    del grads
    states = [{"params": p, "opt": adamw.init(p)} for p in (p_card, p_cpu)]
    steps = [make_train_step(b, opt) for b in (on_card, on_cpu)]
    for i in range(2):
        metrics = []
        for k in range(2):
            states[k], m = steps[k](states[k], data.batch_at(i))
            metrics.append(m)
        losses = [float(m["loss"]) for m in metrics]
        close(torch.tensor(losses[0]), torch.tensor(losses[1]), 0, 1e-4,
              f"    step {i} loss {losses[0]:.6f}, card vs CPU")
        if i == 0:
            norms = [float(m["grad_norm"]) for m in metrics]
            close(torch.tensor(norms[0]), torch.tensor(norms[1]), 1e-4, 0,
                  f"    step 0 grad norm {norms[0]:.6f}, card vs CPU")
    del states, p_card, p_cpu


def mobilellm_restart(close) -> None:
    """(c) MobileLLM-125M unreduced with compressed gradients: 12 steps
    under a Supervisor, checkpoints every 5 under build/, an injected
    failure at step 8; one restart, 12 steps, and steps 10-11's losses
    those of an uninterrupted run at rtol 1e-5."""
    import shutil

    import torch

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.supervisor import InjectedFailure, Supervisor
    from repro_torch.runtime.train_loop import (Trainer, init_train_state,
                                                make_train_step)

    cfg = get_config("mobilellm_125m")
    bundle = build(cfg, remat="none")
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100,
                      weight_decay=0.0)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(ckpt):
        state = init_train_state(
            bundle, torch.Generator(device="cuda").manual_seed(SEED), opt,
            compress_grads=True)
        return Trainer(bundle, opt, SyntheticLM(cfg.vocab_size, 128, 8,
                                                seed=SEED),
                       state, make_train_step(bundle, opt,
                                              compress_grads=True),
                       ckpt, checkpoint_every=5)

    reference = trainer(None)
    want = [r.loss for r in reference.run(12)]
    del reference
    t = trainer(CheckpointManager(ckpt_dir))
    crashed = []

    def bomb(step):
        if step == 8 and not crashed:
            crashed.append(step)
            raise InjectedFailure()

    t0 = time.perf_counter()
    rep = Supervisor(t, failure_hook=bomb).run(12)
    wall = time.perf_counter() - t0
    print(f"  (c) {cfg.name} ({cfg.dtype} compute, int8-compressed "
          f"gradients with error feedback): restarts {rep.restarts}, "
          f"completed steps {rep.completed_steps}, {wall:.2f} s with two "
          f"checkpoints and one restore; uninterrupted losses "
          + " ".join(f"{x:.4f}" for x in want))
    if rep.restarts != 1 or rep.completed_steps != 12:
        raise RuntimeError(f"restart: {rep}")
    got = sorted(r.loss for r in t.records if r.step in (10, 11))
    close(torch.tensor(got), torch.tensor(sorted(want[10:12])), 1e-5, 0,
          "    steps 10-11 after the restart vs uninterrupted")
    del t
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def families_train_card_vs_cpu(close) -> None:
    """(d) Every architecture of the pool at reduced(), f32: one train step
    on the card and one on the CPU from the same weights and batch; the
    loss within 1e-4, the grad norm within 1e-4 relative."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import make_train_step

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        on_card, p_card, on_cpu, p_cpu = _card_and_cpu(cfg, SEED)
        batch = on_cpu.make_batch(SEED, ShapeSpec("t", 32, 2, "train"))
        got = [make_train_step(b, opt)({"params": p, "opt": adamw.init(p)},
                                       batch)[1]
               for b, p in ((on_card, p_card), (on_cpu, p_cpu))]
        close(got[0]["loss"].cpu(), got[1]["loss"], 0, 1e-4,
              f"  (d) {cfg.name} ({cfg.family}) loss "
              f"{float(got[1]['loss']):.5f}, card vs CPU")
        close(got[0]["grad_norm"].cpu(), got[1]["grad_norm"], 1e-4, 0,
              f"      grad norm {float(got[1]['grad_norm']):.5f}")


def require_free_card(card_line: str) -> None:
    """Fail unless under 1 GB of the card is allocated (after a collect),
    naming the largest tensors still there."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"  {held / 1e9:.3f} GB allocated on the card at the phase's start"
          f" ({card_line})")
    if held >= 1e9:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), o.dtype)
                       for o in gc.get_objects()
                       if torch.is_tensor(o) and o.is_cuda), reverse=True)
        print("  the largest tensors still on the card: "
              + "; ".join(f"{tuple(s)} {d} {b / 1e6:.1f} MB"
                          for b, s, d in live[:12]))
        raise RuntimeError(f"{held / 1e9:.2f} GB still allocated before "
                           f"training: an earlier phase holds card memory")


def training_phase(card_line: str, close) -> tuple[list[float], dict]:
    """Phase 9: (a) Granite-3-2B training at full width, (b) card against
    CPU, (c) restart, (d) every family at reduced(). Returns (a)'s
    losses and its analyzed step (phase 11 (b))."""
    require_free_card(card_line)
    t0 = time.perf_counter()
    losses, calibration = granite_training(card_line)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mobilellm_card_vs_cpu(close)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mobilellm_restart(close)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families_train_card_vs_cpu(close)
    print(f"  (d) took {time.perf_counter() - t0:.1f} s")
    return losses, calibration


# Phase 10: sharded training (T1-mesh). Phase 9's (a) through the
# launcher's --mesh host: jit_train_step on the (1, 1) NCCL mesh.
PRODUCTION_REFUSAL = "needs 256 ranks; this world has 1"


def sharded_training_phase(card_line: str, unsharded: list[float]) -> None:
    """Phase 10: Granite-3-2B unreduced, TRAIN_STEPS steps through the
    launcher's mesh (``train_mesh``, ``make_trainer`` on it, a
    ``Supervisor``), each loss within 1e-5 of phase 9's ``unsharded``; the
    step, tokens/s, peak memory and one profiled step; no process group
    after it; then ``--mesh production`` refused for lack of ranks."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.supervisor import Supervisor

    require_free_card(card_line)
    argv = ["--arch", "granite_3_2b", "--no-reduced", "--steps",
            str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--seed", str(SEED)]
    args = launch_train.parse_args(argv + ["--mesh", "host"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launch_train.train_mesh(args) as mesh:
        if (tuple(mesh.shape), mesh.mesh_dim_names,
                dist.get_backend()) != ((1, 1), ("data", "model"), "nccl"):
            raise RuntimeError(f"--mesh host built {mesh} on "
                               f"{dist.get_backend()}")
        trainer = launch_train.make_trainer(args, mesh)
        torch.cuda.synchronize()
        params = list(trainer.state["params"].parameters())
        if not all(isinstance(p, DTensor) for p in params):
            raise RuntimeError("the sharded state holds plain tensors")
        n = sum(p.numel() for p in params)
        tokens = args.batch * args.seq_len
        print(f"  {n} parameters drawn and laid out on {mesh} "
              f"({dist.get_backend()}) in {time.perf_counter() - t0:.2f} s; "
              f"placements of layers.attn.wq: "
              f"{trainer.state['params'].layers.attn.wq.placements}")
        report = Supervisor(trainer).run(TRAIN_STEPS)
        recs = trainer.records
        losses = [r.loss for r in recs]
        print("  losses " + " ".join(f"{x:.4f}" for x in losses))
        if report.completed_steps != TRAIN_STEPS or report.restarts:
            raise RuntimeError(f"sharded training: {report}")
        diff = max(abs(a - b) for a, b in zip(losses, unsharded, strict=True))
        print(f"  largest loss difference from phase 9's unsharded steps "
              f"{diff:.3e} (must be within 1e-5)")
        if not diff <= 1e-5:
            raise RuntimeError(f"sharded losses differ from phase 9's by "
                               f"{diff}")
        step_s = statistics.median(r.wall_s for r in recs[3:TRAIN_STEPS])
        peak = torch.cuda.max_memory_allocated()
        print(f"  first step {recs[0].wall_s * 1e3:.2f} ms (DTensor's "
              f"sharding propagation is cached from the second); step "
              f"{step_s * 1e3:.2f} ms (median of steps 3-19), "
              f"{tokens / step_s:.0f} tokens/s; peak memory "
              f"{peak / 1e9:.2f} GB ({card_line})")
        profile_train_step(trainer, "one sharded step")
        del trainer, params
    if dist.is_initialized():
        raise RuntimeError("the launcher's process group outlived its run")
    print("  after the run: no process group, the hooks cleared "
          f"({launch_train.model_layers._BATCH_AXES is None})")
    try:
        launch_train.main(argv + ["--mesh", "production"])
    except RuntimeError as e:
        if PRODUCTION_REFUSAL not in str(e):
            raise
        print(f"  --mesh production on this card: RuntimeError: {e}")
    else:
        raise RuntimeError("--mesh production ran on one card")
    if dist.is_initialized():
        raise RuntimeError("--mesh production left a process group")
    torch.cuda.empty_cache()


# Phase 11: the dry run (D1). Its cells run in subprocesses of the CLI, so
# that their fake process groups never meet phase 10's NCCL group.
DRYRUN_CELLS = (("granite_3_2b", "train_4k", "single"),
                ("qwen2_moe_a2_7b", "train_4k", "single"),
                ("qwen2_moe_a2_7b", "decode_32k", "multi"))
# The (1, 1) trace of phase 9's analyzed step: the launcher's model, step
# and optimizer on a meta state, its batch meta stand-ins; one JSON line.
CALIBRATION_TRACE = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model_zoo import build
from repro_torch.runtime.train_loop import (init_train_state,
                                            jit_train_step, make_train_step)
args = launch_train.parse_args(sys.argv[1:])
cfg = get_config(args.arch)
opt = launch_train.opt_config(args)
shape = ShapeSpec("t1", args.seq_len, args.batch, "train")
bundle = build(cfg, remat=args.remat, device="meta")
with dryrun.fake_world(1):
    mesh = make_host_mesh("cpu")
    state = init_train_state(bundle, None, opt)
    step, _, _ = jit_train_step(make_train_step(bundle, opt), state, mesh,
                                {"tokens": 2})
    rec = dryrun.trace_step(step, (state, dryrun.input_specs(
        cfg, shape, "train")), mesh, {}, cfg, shape)
print(json.dumps(rec))
"""


def _dryrun_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))


def dryrun_cells(card_line: str) -> None:
    """(a) Each of DRYRUN_CELLS through ``python -m
    repro_torch.launch.dryrun``: per-device flops, bytes, collective bytes
    by op, peak estimate against the card's memory, the dominant term,
    roofline fraction and trace time. A cell that fails, or a train cell
    whose peak estimate is over the card's memory, fails the phase."""
    from repro_torch.launch.report import HBM_BYTES

    out = os.path.join(ROOT, "build", "chip_smoke_dryrun.json")
    if os.path.exists(out):
        os.remove(out)
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=_dryrun_env(),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise RuntimeError(f"{' '.join(cmd[1:])}: exit code "
                               f"{proc.returncode}")
        with open(out) as f:
            key = f"{arch}/{shape}/{'2x16x16' if mesh == 'multi' else '16x16'}"
            rec = json.load(f)[key]
        if not rec["ok"]:
            raise RuntimeError(f"dry run {key}: {rec['error']}\n"
                               f"{rec['traceback']}")
        a, r = rec["analysis"], rec["roofline"]
        peak = rec["memory"]["peak_estimate_bytes"]
        print(f"  (a) {key} ({wall:.1f} s in its process, trace "
              f"{rec['trace_s']} s): per device {a['flops']:.4e} flops, "
              f"{a['bytes']:.4e} bytes, collective bytes "
              f"{json.dumps(a['collective_bytes_by_op'])} "
              f"(counts {json.dumps(a['collective_counts'])}); peak "
              f"estimate {peak / 1e9:.2f} GB against the card's "
              f"{HBM_BYTES / 1e9:.2f} GB; t_compute {r['t_compute_s']:.4e} "
              f"s, t_memory {r['t_memory_s']:.4e} s, t_collective "
              f"{r['t_collective_s']:.4e} s: {r['dominant']}-bound, "
              f"roofline fraction {r['roofline_fraction']:.4f}")
        if rec["kind"] == "train" and peak > HBM_BYTES:
            raise RuntimeError(f"dry run {key}: peak estimate "
                               f"{peak / 1e9:.2f} GB is over the card's "
                               f"{HBM_BYTES / 1e9:.2f} GB")
    print(f"  (card: {card_line})")


def dryrun_calibration(card_line: str, calibration: dict) -> None:
    """(b) Phase 9's analyzed card step against the same step traced on a
    fake (1, 1) mesh with a meta state (in a subprocess): the same flops
    and bytes exactly, no collective; both beside 6 N D, the profiled
    card time and max_memory_allocated."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    argv = ["--arch", "granite_3_2b", "--no-reduced", "--steps",
            str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--seed", str(SEED)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CALIBRATION_TRACE, *argv],
                          cwd=ROOT, env=_dryrun_env(), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise RuntimeError(f"the (1, 1) trace: exit code {proc.returncode}")
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    card = calibration["analysis"]
    t = traced["analysis"]
    cfg = get_config("granite_3_2b")
    mf = dryrun.model_flops(cfg, ShapeSpec("t1", 128, 8, "train"), "train")
    t_compute, t_memory = card["flops"] / dryrun.PEAK_FLOPS, \
        card["bytes"] / dryrun.HBM_BW
    print(f"  (b) phase 9's step (batch 8 x seq 128, remat none) analyzed on "
          f"the card in {calibration['analyze_s']:.2f} s: {card['flops']:.6e}"
          f" flops ({card['flops'] / mf:.4f} x 6 N D = {mf:.6e}), "
          f"{card['bytes']:.6e} bytes, {card['n_instructions']:.0f} ops, "
          f"collectives {json.dumps(card['collective_counts'])}")
    print(f"      traced on a fake (1, 1) mesh with a meta state in "
          f"{time.perf_counter() - t0:.1f} s (trace {traced['trace_s']} s): "
          f"{t['flops']:.6e} flops, {t['bytes']:.6e} bytes, "
          f"{t['n_instructions']:.0f} ops, collectives "
          f"{json.dumps(t['collective_counts'])}")
    if (t["flops"], t["bytes"]) != (card["flops"], card["bytes"]) or \
            t["collective_bytes"] or t["collective_counts"] or \
            card["collective_counts"]:
        raise RuntimeError("the dry run's trace does not count what the "
                           "card ran")
    print(f"      t_compute {t_compute * 1e3:.3f} ms, t_memory "
          f"{t_memory * 1e3:.3f} ms, max {max(t_compute, t_memory) * 1e3:.3f}"
          f" ms against phase 9's profiled card time "
          f"{calibration['card_ms']:.3f} ms (the optimizer's range "
          f"{calibration['opt_ms']:.3f} ms); peak estimate "
          f"{calibration['memory']['peak_estimate_bytes'] / 1e9:.2f} GB "
          f"(traced {traced['memory']['peak_estimate_bytes'] / 1e9:.2f}) "
          f"against this step's max_memory_allocated "
          f"{calibration['max_memory_allocated'] / 1e9:.2f} GB and phase "
          f"9's {calibration['peak'] / 1e9:.2f} GB ({card_line})")


# Phase 12: the examples, each in a subprocess on the card at short
# settings, and the lines of its printout that carry its result.
EXAMPLES = (
    (("train_lm_torch.py", "--steps", "20"), ("training ", "loss ")),
    (("serve_lm_torch.py", "--continuous-tune", "--tune-trials", "4"),
     ("arch=", "prefill(", "decode (", "cold dispatch", "after ")),
    (("tune_workload_torch.py", "--trials", "4"),
     ("bert-tiny total", "session wall time", "database records")),
)


def examples_phase(card_line: str) -> None:
    """Each of EXAMPLES through ``python examples/<name>`` on the card: its
    exit code, wall seconds and key lines; an exit code other than 0 fails
    the phase."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for (name, *argv), keys in EXAMPLES:
        cmd = [sys.executable, os.path.join("examples", name), *argv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        print(f"  python examples/{name} {' '.join(argv)}: exit code "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s")
        for line in proc.stdout.splitlines():
            if line.strip().startswith(keys):
                print("    " + line.strip())
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"examples/{name} failed")
    print(f"  (card: {card_line})")


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
            lq, d = wl.dims[3], wl.dims[5]
            bound, by = bound_ms(x[:3], kern(*args)[:, :lq, :d],
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
            n, k = wl.dims
            bound, by = bound_ms(x[:2], kern(*args)[..., :n], 2.0 * n * k,
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
            m, n, k = wl.dims
            bound, by = bound_ms(x[:2], kern(*args)[:m, :n],
                                 2.0 * m * n * k, wl.dtype)
        tf32 = {}
        if wl.op == "matmul" and wl.dtype == "float32":
            tf32["bound_3xtf32_ms"] = 3 * 2.0 * m * n * k / PEAK_TF32 * 1e3
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

    # ---------------------------------------------------------------- 6 ----
    phase(f"6. serving path: MobileLLM-125M unreduced through Server, "
          f"dispatch miss recording and ContinuousTuner on CudaRunner "
          f"(batch 1 and 4, {SERVE_TRIALS} trials a shape, seed {SEED})")
    launches6 = serving_phase(runner, card_line, close)
    print(f"launches on the serving path: {launches6}")

    # ---------------------------------------------------------------- 7 ----
    phase(f"7. measurement farm: MobileLLM-125M batch-1 decode (N10) through "
          f"a BoardFarm of one LocalBoard (TuningSession, depth 2, "
          f"{FARM_TRIALS} trials a shape, seed {SEED}); fault isolation; "
          f"examples/quickstart_torch.py")
    launches7 = farm_phase(runner, close,
                           sessions["mobilellm_125m decode"].tuned_latency,
                           results[wl1.key()][0].best_schedule)
    print(f"launches on the farm path (its worker's): {launches7}")

    # ---------------------------------------------------------------- 8 ----
    phase(f"8. the other model families: Qwen1.5-MoE-A2.7B unreduced through "
          f"Server, dispatch miss recording and ContinuousTuner on "
          f"CudaRunner (batch 1 and 4, {SERVE_TRIALS} trials a shape, seed "
          f"{SEED}); Mamba2-780M, RecurrentGemma-2B and Whisper-tiny at "
          f"their published widths")
    launches8, moe_tuned = families_phase(runner, card_line, close)
    print(f"launches on the families' paths: {launches8}")
    for r in rows:
        r["launches"] += launches6.get(r["name"], 0) \
            + launches7.get(r["name"], 0) + launches8.get(r["name"], 0)
    # Qwen1.5-MoE's five decode shapes on the blocks its tuner cycles
    # chose: the gemv kernels at batch 1, the bf16 matmul kernels at batch
    # 4; launches: the kernel's over every phase, as on its earlier row
    total_launches = {r["name"]: r["launches"] for r in rows}
    moe_rows = []
    for batch, (moe_db, moe_reports) in sorted(moe_tuned.items()):
        for rep in moe_reports:
            params_t = concretize(rep.workload, H100,
                                  moe_db.best(rep.workload, H100.name)[0])
            name = {("gemv", True): "_gemv_kernel",
                    ("gemv", False): "_gemv_noacc_kernel",
                    ("matmul", True): "_acc_kernel",
                    ("matmul", False): "_noacc_kernel"}[
                rep.workload.op, bool(params_t.accumulate)]
            r = row(name, rep.workload, params_t,
                    f"Qwen1.5-MoE decode batch {batch} {rep.workload.op}"
                    f"({', '.join(map(str, rep.workload.dims))}) "
                    f"(x{rep.count})")
            r["launches"] = total_launches[name]
            moe_rows.append(r)

    # ---------------------------------------------------------------- 9 ----
    phase(f"9. training (T1): Granite-3-2B unreduced through the train "
          f"launcher's Trainer under a Supervisor ({TRAIN_STEPS} steps, "
          f"batch 8 x seq 128, lr {TRAIN_LR}); card against CPU, restart and "
          f"every family's step at reduced()")
    t0 = time.perf_counter()
    # the runner's operands of every workload timed so far (the MoE rows'
    # 151936 x 2048 weights among them) are the card memory still held
    runner.clear_inputs()
    unsharded, calibration = training_phase(card_line, close)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------------- 10 ----
    phase(f"10. sharded training (T1-mesh): Granite-3-2B unreduced through "
          f"the train launcher's --mesh host (jit_train_step on a (1, 1) "
          f"NCCL mesh, {TRAIN_STEPS} steps as phase 9's); --mesh production "
          f"refused on one card")
    t0 = time.perf_counter()
    sharded_training_phase(card_line, unsharded)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------------- 11 ----
    phase("11. the dry run (D1): three cells on the production meshes "
          "through python -m repro_torch.launch.dryrun; phase 9's step on "
          "the card against its trace on a fake (1, 1) mesh")
    t0 = time.perf_counter()
    dryrun_cells(card_line)
    dryrun_calibration(card_line, calibration)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------------- 12 ----
    phase("12. the examples on the card: train_lm_torch.py, "
          "serve_lm_torch.py --continuous-tune, tune_workload_torch.py")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    examples_phase(card_line)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")

    print("rows " + json.dumps(rows))
    print(card_line)
    strip = ("workload", "block", "bound_3xtf32_ms", "sdpa_backend")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in strip}
                                  for r in (acc3, noacc3, qmm2, gemv_acc,
                                            gemv_noacc, vmacc_row, fa_row,
                                            fa_long_row, acc3_f32,
                                            noacc3_f32, n6_row, n7_row,
                                            *moe_rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
