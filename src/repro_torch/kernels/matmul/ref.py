"""Plain PyTorch oracle for the matmul kernel (the JAX package's ref.py)."""

import torch


def matmul_ref(x, w):
    if x.dtype in (torch.int8, torch.uint8):
        # exact in float64 (see plain.block_product); CUDA has no int matmul
        return (x.double() @ w.double()).to(torch.int32)
    return (x.float() @ w.float()).to(x.dtype)
