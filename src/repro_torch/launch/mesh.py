"""Mesh construction (the JAX package's ``launch/mesh.py``, ported to
``DeviceMesh``).

Defined as functions (never module-level constants) so that importing this
module touches no process group and no device.

``make_host_mesh`` is the one-device mesh with the production axis names;
with no process group yet it makes a world of one in memory (a
``HashStore``: no port, no peer). ``make_production_mesh`` lays the world's
ranks out as the reference's 16x16 (or 2x16x16) mesh, and refuses a world
of another size, as ``jax.make_mesh`` refuses a device count that does not
fill the shape. A process group this module made is destroyed by
:func:`release_mesh`.
"""

from __future__ import annotations

import math
import os

import torch.distributed as dist

# Whether this module initialized the default process group: only then does
# release_mesh destroy it.
_OWNS_GROUP = False


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _world_size() -> int:
    """The ranks of the running world: the process group's, or those a
    launcher's environment announces (one without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _make_mesh(device: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if world != math.prod(shape):
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh {axes} needs "
            f"{math.prod(shape)} ranks; this world has {world}")
    global _OWNS_GROUP
    if not dist.is_initialized():
        if world == 1:
            dist.init_process_group(_backend(device), store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:  # a launcher's environment (MASTER_ADDR, RANK, WORLD_SIZE)
            dist.init_process_group(_backend(device))
        _OWNS_GROUP = True
    if device == "cuda":
        import torch

        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(device, shape, axes)


def make_host_mesh(device: str = "cuda"):
    """Single-device mesh with the production axis names."""
    return _make_mesh(device, (1, 1), ("data", "model"))


def release_mesh() -> None:
    """Destroy the default process group if a mesh of this module made it."""
    global _OWNS_GROUP
    if _OWNS_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWNS_GROUP = False
