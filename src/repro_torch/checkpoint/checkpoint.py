"""Atomic, elastic checkpointing, in the JAX package's on-disk layout.

Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per leaf, named by its
``__``-joined path, plus ``manifest.json`` (step, shapes, dtypes, extra
metadata). A state is a nested dict / list / tuple whose leaves are
tensors, numpy arrays or scalars; an ``nn.Module`` in it stands for its
``state_dict`` (``layers.attn.wq`` is the path ``layers``, ``attn``,
``wq``), so a model's parameters and the JAX package's parameter tree share
their files: a checkpoint written by either package restores in the other.
Writes go to a temp directory and are ``os.replace``d into place — a crash
mid-save never corrupts the latest checkpoint.

Sharded states (DTensor leaves) are written as full arrays: every rank
gathers each leaf, rank 0 writes (synchronously, the other ranks waiting
for it at a barrier). Elastic restore: leaves are loaded host-side and
laid out by the *target* shardings (``restore(shardings=)``), so a
checkpoint written on mesh A restores onto mesh B (another rank count or
axis sizes), or onto one device without them.

``async_save`` moves serialization off the calling thread (the host copy
is made synchronously; the disk write overlaps what follows).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_SEP = "__"


def _children(node):
    """(name, child) pairs of an inner node of a state tree, or None for a
    leaf. A module's children are its state_dict's entries, split on
    their dots."""
    if isinstance(node, nn.Module):
        tree: dict = {}
        for key, value in node.state_dict().items():
            *path, last = key.split(".")
            sub = tree
            for part in path:
                sub = sub.setdefault(part, {})
            sub[last] = value
        return list(tree.items())
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host_copy(leaf) -> np.ndarray:
    if _is_dtensor(leaf):  # every rank takes part in the gather
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree, prefix: tuple = ()) -> dict[str, np.ndarray]:
    children = _children(tree)
    if children is None:
        return {_SEP.join(prefix): _host_copy(tree)}
    flat = {}
    for name, child in children:
        flat.update(_flatten(child, prefix + (name,)))
    return flat


def _unflatten(template, flat: dict[str, np.ndarray], device,
               shardings=None, prefix: tuple = ()):
    """``template``'s structure with its leaves from ``flat``: each laid out
    by its entry of ``shardings`` (a tree of the template's structure,
    keyed like a module's nested parameter names) where given, else a
    tensor on ``device``."""
    def leaf(path):
        x = torch.from_numpy(flat[_SEP.join(path)])
        if shardings is None:
            return x.to(device)
        s = shardings
        for key in path[len(prefix):]:
            s = s[key]
        return s.place(x.to(s.mesh.device_type))

    if isinstance(template, nn.Module):
        keys = list(template.state_dict())
        if shardings is None:
            template.to(device)
            template.load_state_dict({k: torch.from_numpy(
                flat[_SEP.join(prefix + tuple(k.split(".")))]) for k in keys})
        else:  # new DTensor parameters on the target mesh
            template.load_state_dict(
                {k: leaf(prefix + tuple(k.split("."))) for k in keys},
                assign=True)
        return template
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, device,
                              None if shardings is None else shardings[k],
                              prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, flat, device,
                       None if shardings is None else shardings[i],
                       prefix + (str(i),))
            for i, v in enumerate(template))
    return leaf(prefix)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---- save -----------------------------------------------------------------
    def save(self, step: int, state: dict[str, Any],
             extra: dict | None = None, async_save: bool = False) -> None:
        # Host copy happens synchronously (consistent snapshot)...
        flat = _flatten(state)
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        if dist.is_initialized() and dist.get_world_size() > 1:
            # several ranks: rank 0 writes while the others wait, so that a
            # restore on any rank finds the checkpoint
            if dist.get_rank() == 0:
                self._write(step, flat, manifest)
            dist.barrier()
        elif async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, manifest)

    def _write(self, step: int, flat, manifest) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            for k, v in flat.items():
                np.save(os.path.join(tmp, k + ".npy"), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, device="cuda",
                shardings=None) -> tuple[int, Any, dict]:
        """Load into the structure of ``template``. ``shardings`` (the same
        tree structure, a ``NamedSharding`` at each leaf) lays each leaf
        out on its mesh: the elastic path, onto the current mesh whatever
        mesh wrote the checkpoint; a module in the template gets new
        DTensor parameters. Without it every leaf is a tensor on
        ``device``, and a module is moved there and loads its state in
        place."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {k: np.load(os.path.join(d, k + ".npy"))
                for k in manifest["leaves"]}
        return (step, _unflatten(template, flat, device, shardings),
                manifest["extra"])
