"""No module the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is the port, ``repro`` the
reference), and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def sources():
    for base, dirs, files in os.walk(harness.BENCH):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(top_level_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(harness.BENCH, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            names = set(top_level_imports(os.path.join(ref_dir, f)))
            assert names <= {"__future__", "importlib", "math", "torch"}, \
                (f, names)


def test_a_run_process_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from portbench import check, control, harness, inputs, roofline\n"
        "from portbench import trace\n"
        "from portbench.loops import passes\n"
        "import importlib, os, glob\n"
        "for p in glob.glob(os.path.join(harness.BENCH, 'metrics', '*.py')):\n"
        "    importlib.import_module('portbench.metrics.'"
        " + os.path.basename(p)[:-3])\n"
        "import repro_torch.core.session, repro_torch.core.dispatch\n"
        "import repro_torch.core.runner, repro_torch.kernels\n"
        "print(harness.forbidden_modules())\n").format(
            root=harness.ROOT, src=os.path.join(harness.ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
