"""Picklable pool tasks for the port's measurement-farm tests and for
``chip_smoke.py`` phase 7 (the port's counterpart of tests/_pool_tasks.py,
which the port's pool tests also import as it is).

Spawned workers pickle a task by reference and re-import this module by
name, so every task lives at module level. Nothing here imports torch or
the kernels at import time: a task that needs them imports them when it
runs, inside the worker.
"""

import os

# Card cycles a second for ``torch.cuda._sleep``: about the H100 SXM's
# boost clock, so a spin of s seconds lasts about s seconds.
_CYCLES_PER_S = 2_000_000_000


def launch_fault(code):
    """A kernel launch that returns ``code``: 700 (an illegal address, a
    fault) or 9 (an invalid configuration, a refused launch)."""
    from repro_torch.kernels._build import KernelLaunchError

    raise KernelLaunchError("stand_in_kernel", code, "raised by a test")


def visible_cards(_):
    """The cards this worker may see (``CUDA_VISIBLE_DEVICES``)."""
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def accelerator_error(msg):
    """The exception torch raises for a CUDA error (a device-side assert
    surfacing at a synchronize), raised without a card."""
    import torch

    raise torch.AcceleratorError(msg)


def card_task(payload):
    """One task of the fault-isolation sequence on the card, by kind:

    - ``("measure", (hw, workload, schedule, repeats, warmup))``: the pool's
      real measurement task, ``CudaRunner`` on the worker's card;
    - ``("device_assert", None)``: an out-of-range index on a CUDA tensor;
      the indexing kernel's bounds assert fires on the card and leaves the
      context unusable, and the synchronize raises;
    - ``("spin", seconds)``: a kernel that spins on the card for about
      ``seconds`` (``torch.cuda._sleep``), the stand-in for a wedged kernel;
    - ``("launch_counts", None)`` / ``("reset_launch_counts", None)``: this
      worker's kernel launch counts (they are per process), or zero them.
    """
    kind, arg = payload
    if kind == "measure":
        from repro_torch.core.measure_pool import _measure_candidate

        return _measure_candidate(arg)
    import torch

    from repro_torch import kernels

    if kind == "device_assert":
        t = torch.zeros(4, device="cuda")
        t[torch.tensor([7], device="cuda")]
        torch.cuda.synchronize()
        return "no fault"
    if kind == "spin":
        torch.cuda._sleep(int(arg * _CYCLES_PER_S))
        torch.cuda.synchronize()
        return arg
    if kind == "launch_counts":
        return kernels.launch_counts()
    if kind == "reset_launch_counts":
        kernels.reset_launch_counts()
        return None
    raise ValueError(f"unknown card task {kind!r}")


def measure_or_fault(payload):
    """LocalBoard task: measure a candidate as the default task does, but
    take a schedule whose variant is ``"device_assert"`` to the card's
    device-side assert instead (a candidate that faults on the card)."""
    from repro_torch.core.measure_pool import _measure_candidate

    if payload[2].as_dict().get("variant") == "device_assert":
        return card_task(("device_assert", None))
    return _measure_candidate(payload)


def measure_or_counts(payload):
    """LocalBoard task: the default measurement for a candidate payload;
    ``"launch_counts"`` / ``"reset_launch_counts"`` read or zero the
    worker's kernel launch counts."""
    if isinstance(payload, str):
        return card_task((payload, None))
    from repro_torch.core.measure_pool import _measure_candidate

    return _measure_candidate(payload)
