"""Plain PyTorch oracle for the GEMV kernel (the JAX package's ref.py)."""


def gemv_ref(x, w):
    return x.float() @ w.float()
