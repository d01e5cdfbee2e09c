"""The port's serving launcher on the CPU: ``python -m
repro_torch.launch.serve --device cpu --continuous-tune`` misses in round
0 and is tuned in round 1, for a dense and a moe config (split from
``tests/test_torch_serve.py`` so that ``--dist loadfile`` can spread them
over the test processes: each case starts an interpreter)."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402


def _launch(tmp_path, *args):
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--continuous-tune", "--rounds", "2", "--tune-trials", "2",
         "--gen-steps", "4", "--tune-db", str(tmp_path / "db.json"), *args],
        capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b"])
def test_launcher_serves_the_families_on_the_cpu(tmp_path, arch):
    out = _launch(tmp_path, "--arch", arch)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={get_config(arch).reduced().name} ")
    r0 = next(line for line in lines if line.startswith("round 0"))
    r1 = next(line for line in lines if line.startswith("round 1"))
    assert "dispatch: fixed=" in r0 and "tuned" not in r0
    assert "dispatch: tuned=" in r1 and "fixed" not in r1


def test_launcher_continuous_tune_on_the_cpu(tmp_path):
    out = _launch(tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    r0 = next(line for line in lines if line.startswith("round 0"))
    r1 = next(line for line in lines if line.startswith("round 1"))
    assert "dispatch: fixed=" in r0 and "tuned" not in r0
    assert "dispatch: tuned=" in r1 and "fixed" not in r1
    assert (tmp_path / "db.json").exists()
