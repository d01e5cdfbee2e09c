"""The port's examples at tiny sizes on the CPU: ``examples/
tune_workload_torch.py --cpu`` prints the JAX package's
``examples/tune_workload.py`` table line for line (both tune BERT-tiny
int8 on the analytic v5e model; only the wall-clock seconds differ),
``train_lm_torch.py`` trains a reduced MobileLLM under its supervisor, and
``serve_lm_torch.py --continuous-tune`` serves cold ``fixed``, then
``tuned`` after one tuner cycle. Without a card each refuses to run
rather than fall back to the CPU."""

import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")
# Six test processes share the cores: one intra-op thread each.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _without_seconds(text: str) -> list[str]:
    """The printout's lines, each wall-clock figure ("in 1.3s", "time:
    1.3s") blanked."""
    return [re.sub(r"\d+\.\d+s\b", "<s>", line)
            for line in text.splitlines()]


def test_tune_workload_cpu_prints_the_reference_table(capsys):
    _example("tune_workload").main()
    want = capsys.readouterr().out
    _example("tune_workload_torch").main(["--cpu"])
    got = capsys.readouterr().out
    assert "bert-tiny total: tuned" in got
    assert _without_seconds(got) == _without_seconds(want)


def test_train_lm_cpu_reduced(capsys):
    _example("train_lm_torch").main(["--cpu", "--reduced", "--steps", "4",
                                     "--seq-len", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "training mobilellm-125m-smoke" in out and "on cpu" in out
    losses = [float(x) for x in re.findall(r"loss +(\d+\.\d+) lr", out)]
    assert len(losses) == 4 and all(0 < x < 10 for x in losses)
    assert "over 4 steps (restarts=0)" in out


def test_serve_lm_cpu_continuous_tune(capsys):
    _example("serve_lm_torch").main(["--cpu", "--continuous-tune",
                                     "--tune-trials", "2", "--batch", "2",
                                     "--prompt-len", "8", "--gen-steps", "4"])
    out = capsys.readouterr().out
    cold = re.search(r"cold dispatch: fixed=(\d+) \((\d+) miss", out)
    warm = re.search(r"tuning cycle: tuned=(\d+)$", out, re.M)
    assert cold and warm, out
    assert int(cold.group(1)) == int(warm.group(1)) > 0


@pytest.mark.parametrize("name", ["train_lm_torch", "serve_lm_torch",
                                  "tune_workload_torch"])
def test_examples_need_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    with pytest.raises(RuntimeError):
        _example(name).main(["--steps", "1"] if name == "train_lm_torch"
                            else [])
