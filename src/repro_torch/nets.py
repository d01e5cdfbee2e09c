"""Network -> tensor-workload extraction for the paper's evaluation suite.

The paper tunes per-operator and deploys complete networks (MLPerf Tiny,
MobileNetV2, ResNet18, BERT-tiny, DCGAN, MobileLLM-125M). Each network here
is its operator list — convolutions in im2col matmul form, depthwise stages
as vmacc blocks — with repeat counts, exactly the granularity MetaSchedule
tunes at. Batch = 1 (the paper's edge-inference setting).

Entries: (count, Workload).

A copy of the repo's ``benchmarks/nets.py`` over the port's own workload
module (that file imports the JAX package, which the port never does); the
port's tests hold the two to the same workload keys.
"""

from __future__ import annotations

from repro_torch.core import workload as W


def _conv(out_hw: int, cin: int, cout: int, k: int, dtype: str, n: int = 1):
    """k x k conv as im2col matmul: (out_hw, cout, k*k*cin)."""
    if dtype == "int8":
        return (n, W.qmatmul(out_hw, cout, k * k * cin))
    return (n, W.matmul(out_hw, cout, k * k * cin, dtype))


def _dw(out_hw: int, c: int, k: int, dtype: str, n: int = 1):
    """Depthwise conv: k*k fused multiply-accumulates over (out_hw, c) —
    the Algorithm-2 (vmacc) layer class."""
    return (n * k * k, W.vmacc(out_hw, c, "float32" if dtype != "int8"
                               else "float32"))


def _fc(nout: int, nin: int, dtype: str, n: int = 1):
    if dtype == "int8":
        return (n, W.qmatmul(1, nout, nin))
    return (n, W.gemv(nout, nin, dtype))


def anomaly_detection(dtype="int8"):
    """MLPerf Tiny AD: 640-128x4-8-128x4-640 autoencoder (FC only)."""
    ops = [_fc(128, 640, dtype)]
    ops += [_fc(128, 128, dtype, n=4)]
    ops += [_fc(8, 128, dtype)]
    ops += [_fc(128, 8, dtype)]
    ops += [_fc(128, 128, dtype, n=4)]
    ops += [_fc(640, 128, dtype)]
    return ops


def keyword_spotting(dtype="int8"):
    """MLPerf Tiny KWS: DS-CNN, 49x10 input, 64 channels."""
    ops = [_conv(25 * 5, 1, 64, 10, dtype)]  # first conv 10x4 ~ 10x10 im2col
    for _ in range(4):
        ops.append(_dw(25 * 5, 64, 3, dtype))
        ops.append(_conv(25 * 5, 64, 64, 1, dtype))
    ops.append(_fc(12, 64, dtype))
    return ops


def image_classification(dtype="int8"):
    """MLPerf Tiny IC: ResNet8 on CIFAR-10 (32x32)."""
    ops = [_conv(32 * 32, 3, 16, 3, dtype)]
    ops += [_conv(32 * 32, 16, 16, 3, dtype, n=2)]
    ops += [_conv(16 * 16, 16, 32, 3, dtype, n=2)]
    ops += [_conv(8 * 8, 32, 64, 3, dtype, n=2)]
    ops += [_fc(10, 64, dtype)]
    return ops


def visual_wake_words(dtype="int8"):
    """MLPerf Tiny VWW: MobileNetV1 0.25x at 96x96."""
    ops = [_conv(48 * 48, 3, 8, 3, dtype)]
    chans = [(48 * 48, 8, 16), (24 * 24, 16, 32), (24 * 24, 32, 32),
             (12 * 12, 32, 64), (12 * 12, 64, 64), (6 * 6, 64, 128),
             (6 * 6, 128, 128), (6 * 6, 128, 128), (6 * 6, 128, 128),
             (6 * 6, 128, 128), (3 * 3, 128, 256), (3 * 3, 256, 256)]
    for hw, cin, cout in chans:
        ops.append(_dw(hw, cin, 3, dtype))
        ops.append(_conv(hw, cin, cout, 1, dtype))
    ops.append(_fc(2, 256, dtype))
    return ops


def mobilenetv2(dtype="int8"):
    """MobileNetV2 at 224x224 (expansion blocks as 1x1-dw-1x1)."""
    ops = [_conv(112 * 112, 3, 32, 3, dtype)]
    # (out_hw, cin, expanded, cout, repeats)
    blocks = [
        (112 * 112, 32, 32, 16, 1), (56 * 56, 16, 96, 24, 2),
        (28 * 28, 24, 144, 32, 3), (14 * 14, 32, 192, 64, 4),
        (14 * 14, 64, 384, 96, 3), (7 * 7, 96, 576, 160, 3),
        (7 * 7, 160, 960, 320, 1),
    ]
    for hw, cin, exp, cout, n in blocks:
        ops.append(_conv(hw, cin, exp, 1, dtype, n=n))
        ops.append(_dw(hw, exp, 3, dtype, n=n))
        ops.append(_conv(hw, exp, cout, 1, dtype, n=n))
    ops.append(_conv(7 * 7, 320, 1280, 1, dtype))
    ops.append(_fc(1000, 1280, dtype))
    return ops


def resnet18(dtype="int8"):
    """ResNet18 at 224x224."""
    ops = [_conv(112 * 112, 3, 64, 7, dtype)]
    stages = [(56 * 56, 64, 64, 4), (28 * 28, 64, 128, 4),
              (14 * 14, 128, 256, 4), (7 * 7, 256, 512, 4)]
    for hw, cin, cout, n in stages:
        ops.append(_conv(hw, cin, cout, 3, dtype))
        ops.append(_conv(hw, cout, cout, 3, dtype, n=n - 1))
    ops.append(_fc(1000, 512, dtype))
    return ops


def dcgan(dtype="float32"):
    """DCGAN generator, latent (1, 100) -> 64x64 image (deconvs in
    im2col-equivalent matmul form)."""
    return [
        (1, W.matmul(4 * 4, 512, 100, dtype)),
        (1, W.matmul(8 * 8, 256, 512 * 4, dtype)),
        (1, W.matmul(16 * 16, 128, 256 * 4, dtype)),
        (1, W.matmul(32 * 32, 64, 128 * 4, dtype)),
        (1, W.matmul(64 * 64, 3, 64 * 4, dtype)),
    ]


def bert_tiny(dtype="int8", seq=64):
    """BERT-tiny (2L, d=128, ff=512), sequence length 64 (paper's setting)."""
    d, ff, h = 128, 512, 2
    mm = W.qmatmul if dtype == "int8" else (
        lambda m, n, k: W.matmul(m, n, k, dtype))
    ops = []
    for _ in range(2):
        ops.append((4, mm(seq, d, d)))          # q, k, v, o
        ops.append((1, W.attention(1, h, h, seq, seq, d // h, "float32",
                                   causal=False)))
        ops.append((1, mm(seq, ff, d)))
        ops.append((1, mm(seq, d, ff)))
    ops.append((1, mm(seq, d, d)))              # pooler
    return ops


def mobilellm_125m(dtype="int8", seq=64):
    """MobileLLM-125M (30L, d=576, 9 heads kv=3, ff=1536), seq 64."""
    d, ff, hq, hkv, hd = 576, 1536, 9, 3, 64
    mm = W.qmatmul if dtype == "int8" else (
        lambda m, n, k: W.matmul(m, n, k, dtype))
    ops = [
        (30, mm(seq, hq * hd, d)),               # q
        (60, mm(seq, hkv * hd, d)),              # k, v
        (30, W.attention(1, hq, hkv, seq, seq, hd, "float32")),
        (30, mm(seq, d, hq * hd)),               # o
        (60, mm(seq, ff, d)),                    # gate, up
        (30, mm(seq, d, ff)),                    # down
        (1, mm(seq, 32000, d)),                  # lm head
    ]
    return ops


NETWORKS = {
    "anomaly-detection": anomaly_detection,
    "keyword-spotting": keyword_spotting,
    "image-classification": image_classification,
    "visual-wake-words": visual_wake_words,
    "mobilenetv2": mobilenetv2,
    "resnet18": resnet18,
    "dcgan": dcgan,
    "bert-tiny": bert_tiny,
    "mobilellm-125m": mobilellm_125m,
}
