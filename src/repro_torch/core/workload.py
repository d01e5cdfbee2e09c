"""Workload descriptors — the tensor operations the tuner optimizes.

A :class:`Workload` is the analogue of a TVM task extracted from a network:
an op family plus concrete shapes and dtypes. The tuner's database is keyed
by ``workload.key()`` × hardware name, so a network deployment looks up the
best schedule per (op, shape, dtype, hardware) exactly as the paper's tuned
TVM artifacts do.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np

_DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2,
    "int32": 4, "int8": 1, "uint8": 1,
}


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES[dtype]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One tensor operation instance.

    op families and their ``dims``:
      - ``matmul``:   (m, n, k)            out[m,n] = x[m,k] @ w[k,n] (+ c)
      - ``qmatmul``:  (m, n, k)            int8 QNN matmul + bias + requant
      - ``gemv``:     (n, k)               out[n] = w[n,k] @ x[k] (+ c)  (Alg. 1)
      - ``vmacc``:    (rows, cols)         out = a * b + c elementwise  (Alg. 2)
      - ``attention``:(batch, q_heads, kv_heads, q_len, kv_len, head_dim)
    """

    op: str
    dims: tuple[int, ...]
    dtype: str = "float32"
    out_dtype: str | None = None
    # Free-form tags (e.g. causal attention, requant params presence).
    tags: tuple[str, ...] = ()

    def __post_init__(self):
        if self.out_dtype is None:
            object.__setattr__(self, "out_dtype", self.dtype)

    # ---- identity ----------------------------------------------------------
    def key(self) -> str:
        payload = json.dumps(
            [self.op, list(self.dims), self.dtype, self.out_dtype, list(self.tags)],
            separators=(",", ":"),
        )
        digest = hashlib.sha1(payload.encode()).hexdigest()[:12]
        return f"{self.op}-{'x'.join(map(str, self.dims))}-{self.dtype}-{digest}"

    def to_json(self) -> dict[str, Any]:
        return {
            "op": self.op, "dims": list(self.dims), "dtype": self.dtype,
            "out_dtype": self.out_dtype, "tags": list(self.tags),
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Workload":
        return Workload(
            op=d["op"], dims=tuple(d["dims"]), dtype=d["dtype"],
            out_dtype=d.get("out_dtype"), tags=tuple(d.get("tags", ())),
        )

    # ---- cost facts --------------------------------------------------------
    def flops(self) -> float:
        """Useful FLOPs (multiply-add = 2 FLOPs)."""
        if self.op in ("matmul", "qmatmul"):
            m, n, k = self.dims
            return 2.0 * m * n * k
        if self.op == "gemv":
            n, k = self.dims
            return 2.0 * n * k
        if self.op == "vmacc":
            r, c = self.dims
            return 2.0 * r * c
        if self.op == "attention":
            b, hq, _hkv, ql, kl, d = self.dims
            return 2.0 * b * hq * ql * kl * d * 2  # QK^T and PV
        raise ValueError(f"unknown op {self.op}")

    def min_bytes(self) -> float:
        """Compulsory HBM traffic: each operand read once, output written once."""
        ib, ob = dtype_bytes(self.dtype), dtype_bytes(self.out_dtype)
        if self.op in ("matmul", "qmatmul"):
            m, n, k = self.dims
            return ib * (m * k + k * n) + ob * m * n
        if self.op == "gemv":
            n, k = self.dims
            return ib * (k + n * k) + ob * n
        if self.op == "vmacc":
            r, c = self.dims
            return 3 * ib * r * c + ob * r * c
        if self.op == "attention":
            b, hq, hkv, ql, kl, d = self.dims
            return ib * (b * hq * ql * d + 2 * b * hkv * kl * d) + ob * b * hq * ql * d
        raise ValueError(f"unknown op {self.op}")

    def arithmetic_intensity(self) -> float:
        return self.flops() / max(self.min_bytes(), 1.0)

    # ---- instantiation helpers ---------------------------------------------
    def example_inputs(self, seed: int = 0) -> tuple[np.ndarray, ...]:
        """Concrete numpy inputs for measurement / correctness checks."""
        rng = np.random.default_rng(seed)

        def rand(shape, dtype):
            if dtype in ("int8", "uint8"):
                return rng.integers(-100, 100, size=shape).astype(dtype)
            if dtype == "int32":
                return rng.integers(-1000, 1000, size=shape).astype(dtype)
            return (rng.standard_normal(shape) * 0.5).astype(
                "float32" if dtype == "bfloat16" else dtype)

        if self.op == "matmul":
            m, n, k = self.dims
            return rand((m, k), self.dtype), rand((k, n), self.dtype)
        if self.op == "qmatmul":
            m, n, k = self.dims
            return (rand((m, k), "int8"), rand((k, n), "int8"),
                    rand((n,), "int32"))
        if self.op == "gemv":
            n, k = self.dims
            return rand((1, k), self.dtype), rand((k, n), self.dtype)
        if self.op == "vmacc":
            r, c = self.dims
            return (rand((r, c), self.dtype), rand((r, c), self.dtype),
                    rand((r, c), self.dtype))
        if self.op == "attention":
            b, hq, hkv, ql, kl, d = self.dims
            return (rand((b, hq, ql, d), self.dtype),
                    rand((b, hkv, kl, d), self.dtype),
                    rand((b, hkv, kl, d), self.dtype))
        raise ValueError(f"unknown op {self.op}")


def matmul(m: int, n: int, k: int, dtype: str = "float32") -> Workload:
    return Workload("matmul", (m, n, k), dtype)


def qmatmul(m: int, n: int, k: int) -> Workload:
    return Workload("qmatmul", (m, n, k), "int8", out_dtype="int8")


def gemv(n: int, k: int, dtype: str = "float32") -> Workload:
    return Workload("gemv", (n, k), dtype)


def vmacc(rows: int, cols: int, dtype: str = "float32") -> Workload:
    return Workload("vmacc", (rows, cols), dtype)


def attention(b: int, hq: int, hkv: int, ql: int, kl: int, d: int,
              dtype: str = "float32", causal: bool = True) -> Workload:
    return Workload("attention", (b, hq, hkv, ql, kl, d), dtype,
                    tags=("causal",) if causal else ())
