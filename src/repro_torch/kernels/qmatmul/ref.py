"""Plain PyTorch oracle for the quantized matmul kernel (the JAX package's
ref.py)."""

import torch


def qmatmul_ref(x, w, bias, scale=0.01):
    acc = (x.double() @ w.double()).to(torch.int32)  # exact; see matmul/ref.py
    acc = acc + bias.to(torch.int32)[None, :]
    scaled = acc.to(torch.float32) * scale  # f32 multiply, as in JAX
    return torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)
