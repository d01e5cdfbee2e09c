"""The yardstick: published peaks of one H100 and the least time each op
could take on it.

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates, at its full
power limit of 700 W. An op's bytes (each input read once and the output
written once, at the unpadded shapes) and operations (two for each
multiply-add) are its family's (``reference/<op>.py``). The bound is the
larger of bytes over the HBM rate and operations over the dtype's peak.
"""

from __future__ import annotations

from portbench.reference import family

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def compute_s(op: str, dims, dtype: str) -> float:
    """The operations alone at the dtype's peak."""
    return family(op).op_ops(dims) / PEAK_OPS[dtype]


def bound_s(op: str, dims, dtype: str) -> float:
    return max(family(op).op_bytes(dims, dtype) / HBM_BYTES_PER_S,
               compute_s(op, dims, dtype))


def pass_bound_s(config: dict, op_name: str) -> float:
    """Summed bounds of one pass's launches of ``op_name``."""
    return sum(o["count"] * bound_s(o["op"], o["dims"], o["dtype"])
               for o in config["ops"] if o["op"] == op_name)


def pass_compute_s(config: dict) -> float:
    """One pass's operations at their dtypes' peaks."""
    return sum(o["count"] * compute_s(o["op"], o["dims"], o["dtype"])
               for o in config["ops"])
