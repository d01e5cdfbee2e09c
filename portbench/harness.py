"""The benchmark's frame: the manifest, a cell's files, the run's context and
the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the network's op list and its input rules;
- ``traffic/<mix>.json``: the mix's parameters; its ``loop`` key names the
  loop that runs it, ``loops/<loop>.py``;
- ``metrics/<module>.py``: one reader of a per-layer metric, the module
  named by :func:`metric_module`.

A loop's ``run(ctx)`` sets up, warms up, measures for ``ctx.seconds`` and
returns a :class:`Run`; :func:`execute` then checks the answers against the
plain reference and reads the metrics.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Any, Callable

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names the benchmark's process may never hold: JAX and the
# JAX package the port was made from (compared whole: ``repro_torch`` is the
# port, ``repro`` the reference).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_module(name: str) -> str:
    """The module of a per-layer metric's reader, ``metrics/<module>.py``:
    the metric's name with ``.`` and ``-`` as ``_``."""
    return name.replace(".", "_").replace("-", "_")


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read."""
    name: str
    config: dict
    traffic: dict
    chips: int
    units: dict[str, str]
    end_to_end: list[str]
    per_layer: list[str]


def find_cell(manifest: dict, name: str, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m["name"] for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in manifest["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in e2e)]
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                units=units, end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Context:
    """What a loop is given: the cell, the run's arguments, where the
    kernels run, and the process's start on the host clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str                      # "cuda", or "cpu" in the CPU tests
    t0: float                        # time.perf_counter() at process start
    runner_class: Callable[..., Any]  # CudaRunner on the card
    setup_s: float | None = None

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """Mark the end of set-up: the window starts now."""
        self.setup_s = time.perf_counter() - self.t0


@dataclasses.dataclass
class Answer:
    """One output the timed path produced, with the inputs it was given."""
    op: str
    inputs: tuple
    output: Any


@dataclasses.dataclass
class Run:
    """What a loop hands back once its window has closed."""
    attempted: int
    end_to_end: dict[str, float]
    answers: list[Answer]
    expected_answers: int
    memory_peak_bytes: int
    trace: Any = None                # trace.Trace of the traced part
    facts: dict = dataclasses.field(default_factory=dict)  # for the readers


def loop_module(cell: Cell):
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")


def read_per_layer(cell: Cell, run: Run) -> dict[str, float]:
    """Each per-layer metric of the cell, by its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for name in cell.per_layer:
        reader = importlib.import_module(
            f"portbench.metrics.{metric_module(name)}")
        value = reader.read(run, cell)
        if value is not None:
            out[name] = float(value)
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(ctx: Context) -> tuple[dict, list[str]]:
    """Run the cell's loop, check its answers and read its metrics. Returns
    the result line (a dict) and the lines for standard error."""
    from portbench import check

    run = loop_module(ctx.cell).run(ctx)
    verdict = check.judge(run, ctx.cell.config)
    cell = ctx.cell
    if ctx.trace:
        values = read_per_layer(cell, run)
    else:
        e2e = dict(run.end_to_end, setup_s=ctx.setup_s)
        values = {name: e2e[name] for name in cell.end_to_end}
    metrics = {name: {"value": v, "unit": cell.units[name]}
               for name, v in values.items()}
    device = device_facts(ctx, run)
    line = {"correct": verdict.correct, "attempted": run.attempted,
            "failed": verdict.failed, "metrics": metrics, "device": device}
    if ctx.trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in verdict.numbers.items()}
    err = [f"check {name}: {v!r} (limit {lim!r})"
           for name, (v, lim) in verdict.numbers.items()]
    return line, err


def device_facts(ctx: Context, run: Run) -> dict:
    if ctx.device == "cuda":
        import torch
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": ctx.cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    if ctx.trace and run.trace is not None:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s
    return out
