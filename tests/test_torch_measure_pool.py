"""The port's MeasurePool / SubprocessRunner: process isolation with a true
timeout kill — every case of the JAX package's tests/test_measure_pool.py
with its assertions, over the port's pool — plus what the card adds: a
task that faults on the card retires its worker (a crash and one respawn,
a refused launch is an ordinary error), workers are pinned to their card,
a CUDA configuration raises without a card, and ``SubprocessRunner`` on
``CPU_EMULATE`` gives the in-process ``EmulateRunner``'s verdicts.

The fast cases use the import-light tasks of ``tests/_pool_tasks.py`` (the
reference's, imported as they are) and ``tests/_torch_pool_tasks.py``. The
reference's ``--runslow`` end-to-end case is a card test here (``gpu``
marker, skipped without a card), beside the fault sequence of
``chip_smoke.py`` phase 7(b).

Run the card tests on a machine with an H100:
    python -m pytest -q -m gpu tests/test_torch_measure_pool.py
"""

import math
import pickle
import threading
import time

import pytest

torch = pytest.importorskip("torch")
# Tensors here are small and six test processes share the cores: one
# intra-op thread each, not a pool spinning per process.
torch.set_num_threads(1)

from repro_torch.core import (CPU_EMULATE, H100, INTERPRET, BoardFarm,  # noqa: E402
                              EmulateRunner, LocalBoard, Schedule,
                              SubprocessRunner, TraceSampler, concretize,
                              space_for)
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.measure_pool import INVALID, MeasurePool  # noqa: E402

import _pool_tasks  # noqa: E402
import _torch_pool_tasks  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def test_pool_runs_tasks_in_order():
    with MeasurePool(_pool_tasks.double, workers=2, timeout_s=30.0) as pool:
        out = pool.run_many(list(range(5)))
    assert [o.status for o in out] == ["ok"] * 5
    assert [o.value for o in out] == [0, 2, 4, 6, 8]
    assert pool.restarts == 0


def test_pool_kills_hanging_task_and_reuses_slot():
    """A wedged task is KILLED at its deadline (not abandoned) and the slot
    measures the next candidate. The whole test must finish far inside the
    30s hang to prove the kill."""
    t0 = time.monotonic()
    with MeasurePool(_pool_tasks.sleepy, workers=1, timeout_s=1.0) as pool:
        out = pool.run_many([30.0, 0.01])
        restarts = pool.restarts
    elapsed = time.monotonic() - t0
    assert out[0].status == "timeout"
    assert out[1].status == "ok" and out[1].value == 0.01
    assert restarts == 1  # the hung worker was killed and respawned
    assert elapsed < 15.0  # nowhere near the 30s sleep: the kill is real


def test_pool_task_exception_is_isolated_without_respawn():
    with MeasurePool(_pool_tasks.boom, workers=1, timeout_s=30.0) as pool:
        out = pool.run_many(["a", "b"])
        restarts = pool.restarts
    assert [o.status for o in out] == ["error", "error"]
    assert "RuntimeError" in out[0].error
    assert restarts == 0  # a raising task does not cost a worker


def test_pool_respawns_after_worker_death():
    with MeasurePool(_pool_tasks.die, workers=1, timeout_s=30.0) as pool:
        out = pool.run_many([1, 2])
        restarts = pool.restarts
    assert [o.status for o in out] == ["crash", "crash"]
    assert restarts == 2


def test_pool_spawn_cost_not_billed_to_task_deadline():
    """Worker startup (torch, CUDA and the kernels' build in real use) runs
    before the ready signal; a task short of its own timeout must succeed
    even when spawn plus initialization takes longer than timeout_s."""
    with MeasurePool(_pool_tasks.sleepy, workers=1, timeout_s=1.0,
                     initializer=_pool_tasks.slow_init) as pool:
        out = pool.run_many([0.2])
        restarts = pool.restarts
    assert out[0].status == "ok" and out[0].value == 0.2
    assert restarts == 0


def test_pool_distributes_across_worker_processes():
    # tasks long enough that one worker cannot drain the queue while the
    # other boots: both slots must end up running candidates concurrently
    with MeasurePool(_pool_tasks.pid_after_sleep, workers=2,
                     timeout_s=30.0) as pool:
        out = pool.run_many([0.8] * 4)
    pids = {o.value for o in out if o.ok}
    assert len(pids) == 2  # both slots actually ran tasks


def test_pool_close_idempotent_while_worker_respawns():
    """close() must be idempotent under a mid-respawn race, leave no live
    slot behind, and let the racing run_many drain instead of crashing."""
    pool = MeasurePool(_pool_tasks.sleepy, workers=1, timeout_s=0.3)
    errors = []

    def drive():
        try:
            # every task hangs: each one costs a timeout kill + respawn, so
            # the closing thread below lands mid-respawn with certainty
            pool.run_many([30.0] * 6)
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(e)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    time.sleep(0.45)  # inside the first kill/respawn churn
    pool.close()
    pool.close()  # idempotent
    t.join(timeout=20.0)
    assert not t.is_alive()  # run_many drained, didn't wedge
    assert errors == []  # and didn't crash on the retired slots
    assert all(w is None for w in pool._pool)  # nothing leaked the teardown
    assert pool.closed
    # a closed pool refuses new work uniformly instead of respawning
    out = pool.run_many([0.01])
    assert [o.status for o in out] == ["crash"]


def test_subprocess_runner_timeout_yields_invalid_and_slot_survives():
    """A hanging 'build' in SubprocessRunner surfaces as INVALID within the
    timeout budget, and the runner keeps serving batches afterwards."""
    wl = W.vmacc(8, 8)
    s = Schedule.fixed(variant="x")
    t0 = time.monotonic()
    with SubprocessRunner(INTERPRET, workers=1, timeout_s=1.0,
                          task=_pool_tasks.hang_measure) as runner:
        lats = runner.run_batch(wl, [s, s.replace("variant", "y")])
        assert lats == [INVALID, INVALID]
        assert runner.pool_restarts == 2
        # pool still functional after both kills
        again = runner.run_batch(wl, [s])
        assert again == [INVALID]
    assert time.monotonic() - t0 < 20.0


# ------------------------------------------------------------ the card ----

@pytest.mark.parametrize("task,arg,status", [
    (_torch_pool_tasks.launch_fault, 700, "crash"),   # illegal address
    (_torch_pool_tasks.accelerator_error,
     "CUDA error: device-side assert triggered", "crash"),
    (_torch_pool_tasks.launch_fault, 9, "error"),     # a refused launch
])
def test_pool_fault_on_the_card_retires_its_worker(task, arg, status):
    """A task error that leaves the CUDA context unusable — a launch that
    failed but was not refused, or the CUDA error torch raises — is a crash
    and costs exactly one respawn; the next task runs on a fresh worker. A
    refused launch is an ordinary error: the worker stays up."""
    with MeasurePool(task, workers=1, timeout_s=30.0) as pool:
        first = pool.run_many([arg])
        pid = pool._pool[0].proc.pid if pool._pool[0] is not None else None
        second = pool.run_many([arg])
        restarts = pool.restarts
    assert [o.status for o in first + second] == [status, status]
    if status == "crash":
        assert restarts == 2 and pid is None  # retired, respawned on demand
        assert "KernelLaunchError" in first[0].error or \
            "AcceleratorError" in first[0].error
    else:
        assert restarts == 0 and pid is not None


def test_pool_pins_each_worker_to_its_card(monkeypatch):
    """``devices`` pins slot i's worker (and its respawns) to card
    devices[i] of the parent's visible cards: the worker sees it alone."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6")
    pool = MeasurePool(_pool_tasks.echo, workers=2, devices=[2, 0])
    assert pool._cards == ["6", "3"]
    pool.close()
    with MeasurePool(_torch_pool_tasks.visible_cards, workers=1,
                     timeout_s=30.0, devices=[1]) as pool:
        out = pool.run_many([None])
    assert out[0].value == "5"
    with pytest.raises(ValueError, match="one worker to each card"):
        MeasurePool(_pool_tasks.echo, workers=2, devices=[0])


def test_card_configurations_raise_without_a_card():
    """No CPU fallback: a configuration that runs on the card raises in the
    parent, before any worker is spawned; fork is refused on it; the
    configuration itself pickles (it crosses spawn in every payload)."""
    assert pickle.loads(pickle.dumps(H100)) == H100
    with pytest.raises(ValueError, match="spawn"):
        SubprocessRunner(H100, mp_context="fork")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        SubprocessRunner(H100)
    with pytest.raises(RuntimeError, match="CUDA card"):
        LocalBoard("h100-0", H100, device=0)
    # CPU_EMULATE shares the H100's design space but runs on the host
    SubprocessRunner(CPU_EMULATE, workers=1).close()


def _valid_samples(wl, hw, n, seed=0):
    space = space_for(wl, hw)
    sampler = TraceSampler(seed)
    out, tries = [], 0
    while len(out) < n:
        s = sampler.sample(space)
        tries += 1
        if concretize(wl, hw, s).valid and (s not in out or tries > 50 * n):
            out.append(s)
    return out


def test_subprocess_runner_emulate_matches_in_process_verdicts():
    """SubprocessRunner(CPU_EMULATE) builds and times each candidate with
    EmulateRunner in its worker: the same valid/INVALID verdicts as the
    in-process runner, and finite positive latencies for the valid ones."""
    wl = W.qmatmul(32, 32, 64)
    good = _valid_samples(wl, CPU_EMULATE, 2)
    bad = Schedule.fixed(variant="not_a_registered_variant")
    batch = [good[0], bad, good[1]]
    local = EmulateRunner(CPU_EMULATE, repeats=1, warmup=0).run_batch(wl,
                                                                      batch)
    with SubprocessRunner(CPU_EMULATE, repeats=1, warmup=0, workers=1,
                          timeout_s=120.0) as runner:
        lats = runner.run_batch(wl, batch)
        assert runner.pool_restarts == 0
    assert [math.isfinite(x) for x in lats] == \
        [math.isfinite(x) for x in local] == [True, False, True]
    assert lats[0] > 0 and lats[2] > 0 and lats[1] == INVALID


# ------------------------------------------------------- card tests ----

def _h100_samples(wl, n):
    return _valid_samples(wl, H100, n)


@pytest.mark.gpu
def test_subprocess_runner_end_to_end_cuda_build(cuda):
    """Real measurement in a worker pinned to the card (CudaRunner there):
    valid candidates get finite latencies, an unknown variant stays
    isolated as INVALID, and no worker is lost."""
    wl = W.qmatmul(64, 64, 128)
    good = _h100_samples(wl, 2)
    bad = Schedule.fixed(variant="not_a_registered_variant")
    with SubprocessRunner(H100, repeats=1, warmup=0, workers=1,
                          timeout_s=300.0) as runner:
        lats = runner.run_batch(wl, [good[0], bad, good[1]])
        assert runner.pool_restarts == 0
    assert len(lats) == 3
    assert math.isfinite(lats[0]) and math.isfinite(lats[2])
    assert lats[0] > 0 and lats[2] > 0
    assert lats[1] == INVALID


@pytest.mark.gpu
def test_fault_sequence_on_the_card(cuda):
    """chip_smoke.py phase 7(b): a real candidate, a device-side assert, the
    candidate again, a spin past the deadline, the candidate a third time.
    Each fault costs one respawn; the candidate is measured after each; the
    parent's own context is untouched."""
    from repro_torch.core.measure_pool import _initializer

    wl = W.qmatmul(3136, 64, 576)
    cand = ("measure", (H100, wl, _h100_samples(wl, 1)[0], 10, 2))
    tasks = [cand, ("device_assert", None), cand, ("spin", 8.0), cand]
    with MeasurePool(_torch_pool_tasks.card_task, workers=1, timeout_s=3.0,
                     initializer=_initializer(H100,
                                              _torch_pool_tasks.card_task),
                     devices=[0]) as pool:
        out = pool.run_many(tasks)
        restarts = pool.restarts
    assert [o.status for o in out] == ["ok", "crash", "ok", "timeout", "ok"]
    assert restarts == 2
    lats = [out[i].value for i in (0, 2, 4)]
    assert all(math.isfinite(x) and x > 0 for x in lats)
    assert max(lats) <= 1.2 * min(lats)
    x = torch.ones(4, device="cuda")
    assert float((x + x).sum()) == 8.0  # the parent's context still works


@pytest.mark.gpu
def test_local_board_farm_end_to_end_cuda_build(cuda):
    """A farm of one LocalBoard on the card: finite latencies for valid
    candidates, INVALID isolation for a bad one, submission order kept."""
    wl = W.qmatmul(64, 64, 128)
    good = _h100_samples(wl, 2)
    bad = Schedule.fixed(variant="not_a_registered_variant")
    boards = [LocalBoard("h100-0", H100, repeats=1, warmup=0,
                         candidate_timeout_s=300.0, device=0)]
    with BoardFarm(boards, straggler_timeout_s=600.0) as farm:
        lats = farm.run_batch(wl, [good[0], bad, good[1]])
    assert len(lats) == 3
    assert math.isfinite(lats[0]) and lats[0] > 0
    assert math.isfinite(lats[2]) and lats[2] > 0
    assert lats[1] == INVALID
