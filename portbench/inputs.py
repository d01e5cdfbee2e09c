"""The inputs of a network's ops, made from the seed on the device.

Every launch of a pass gets operands of its own, as every layer of a network
has weights of its own. Each op family's rule is in its reference file
(``reference/<op>.py``), read with the configuration's ``assumed`` keys.
The same seed gives the same inputs: one generator on the device, drawn in
the order of the op list.
"""

from __future__ import annotations

import math

from portbench.reference import family


def expand(config: dict) -> list[dict]:
    """The op list with each entry repeated ``count`` times: one entry a
    launch, in network order."""
    return [op for op in config["ops"] for _ in range(op["count"])]


def unique(config: dict) -> list[dict]:
    """The op list's distinct (op, dims, dtype), first seen first, with the
    counts summed."""
    seen: dict[tuple, dict] = {}
    for op in config["ops"]:
        key = (op["op"], tuple(op["dims"]), op["dtype"])
        if key in seen:
            seen[key]["count"] += op["count"]
        else:
            seen[key] = dict(op)
    return list(seen.values())


def workload(op: dict):
    """The program's ``Workload`` for one entry of the op list."""
    from repro_torch.core.workload import Workload

    return Workload(op["op"], tuple(op["dims"]), op["dtype"],
                    out_dtype=op["dtype"])


def generator(seed: int, device: str):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make(ops: list[dict], config: dict, gen, device: str) -> list:
    return [family(op["op"]).inputs(op["dims"], op["dtype"],
                                    config["assumed"], gen, device)
            for op in ops]


def for_launches(config: dict, seed: int, device: str) -> list[tuple]:
    """Inputs of every launch of a pass, in network order."""
    return make(expand(config), config, generator(seed, device), device)


def pass_bytes(config: dict) -> float:
    """The bytes one pass's launches read and write (``op_bytes``)."""
    return sum(o["count"] * family(o["op"]).op_bytes(o["dims"], o["dtype"])
               for o in config["ops"])


def operand_sets(config: dict, min_bytes: float) -> int:
    """How many sets of a pass's operands make up ``min_bytes`` of its
    bytes; at least one."""
    return max(1, math.ceil(min_bytes / pass_bytes(config)))


def rotation(config: dict, seed: int, device: str,
             min_bytes: float) -> list[list[tuple]]:
    """:func:`operand_sets` sets of every launch's inputs, drawn one after
    another from one generator: the first is :func:`for_launches`' set."""
    gen = generator(seed, device)
    return [make(expand(config), config, gen, device)
            for _ in range(operand_sets(config, min_bytes))]
