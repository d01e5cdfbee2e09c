"""The port stands alone: importing every module of ``src/repro_torch`` (the
training, sharding and dry-run paths' among them) and every module ``chip_smoke.py`` and
``examples/quickstart_torch.py`` name in an import (inside ``main`` too)
loads neither ``jax`` nor any module of the JAX package ``repro``. Checked
in a fresh interpreter, so that what other tests imported does not
count."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, os, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import ast
# chip_smoke.py imports most modules inside main(): import each it names,
# and each the example names
trees = []
for path in ("chip_smoke.py", "examples/quickstart_torch.py"):
    with open(path) as f:
        trees.append(ast.parse(f.read()))
for node in (n for tree in trees for n in ast.walk(tree)):
    if isinstance(node, ast.Import):
        for alias in node.names:
            importlib.import_module(alias.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        base = importlib.import_module(node.module)
        for alias in node.names:
            if not hasattr(base, alias.name):  # a submodule
                importlib.import_module(f"{node.module}.{alias.name}")
# every model family's module among them, the training path's, the
# sharding path's and the dry run's
missing = [m for m in ("repro_torch.models.moe", "repro_torch.models.ssm",
                       "repro_torch.models.griffin",
                       "repro_torch.models.encdec",
                       "repro_torch.data.pipeline",
                       "repro_torch.optim.adamw",
                       "repro_torch.optim.compression",
                       "repro_torch.runtime.train_loop",
                       "repro_torch.runtime.supervisor",
                       "repro_torch.runtime.sharding",
                       "repro_torch.launch.mesh",
                       "repro_torch.launch.train",
                       "repro_torch.launch.dryrun",
                       "repro_torch.launch.op_analysis",
                       "repro_torch.launch.report")
           if m not in sys.modules]
print("missing", missing)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("imported", len([m for m in sys.modules
                       if m.startswith("repro_torch")]))
print("bad", bad)
sys.exit(1 if bad or missing else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    # chip_smoke.py puts tests/ on its path for phase 7's pool tasks
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT, "tests")]))
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n = int(out.stdout.split("imported ")[1].split()[0])
    assert n > 40  # every module was walked, not just the package
