"""Plain PyTorch oracle for the vmacc kernel (the JAX package's ref.py)."""


def vmacc_ref(a, b, c):
    return a * b + c
