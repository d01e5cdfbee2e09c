"""Process-pool candidate measurement with a true per-candidate timeout kill
(the JAX package's ``core/measure_pool.py``, ported).

A candidate measured in the tuning process can take that process down with
it. On the card, a kernel fault (an illegal address, a device-side assert)
leaves the process's CUDA context unusable, so :class:`~repro_torch.core.
runner.CudaRunner` raises and the whole ``tune``, session or
``ContinuousTuner`` cycle ends; a kernel that never completes (a cluster
that never meets its ``cluster.sync()``) has no deadline at all.

:class:`MeasurePool` removes both failure modes by running each candidate in
a persistent worker *process*:

- a candidate that exceeds ``timeout_s`` is killed with ``Process.kill()``
  (SIGKILL; the CUDA driver tears down the worker's context with it) and its
  worker is respawned, so the slot is reusable immediately and a hung
  candidate can never starve the pool;
- a candidate that crashes its worker outright (segfault, ``os._exit``) is
  reported as a crash and the worker is respawned the same way;
- a candidate that faults on the card (a :class:`~repro_torch.kernels.
  _build.KernelLaunchError` that is not a refused launch, or any CUDA error
  torch raises) is reported as a crash too: its worker reports the error
  and exits, since its context would poison every later candidate, and the
  pool respawns it;
- a candidate whose task merely *raises* anything else is reported as an
  error and the worker stays up (no respawn cost).

Workers are persistent: the expensive part of process isolation (spawning an
interpreter, importing torch, CUDA start-up and the kernels' build) is paid
once per worker, not per candidate — and never against a candidate's
deadline: a worker signals readiness after its optional ``initializer``
runs, dispatch waits for that signal (bounded by ``spawn_timeout_s``), and
only then does the per-task ``timeout_s`` clock start. A slow build after a
respawn is therefore judged on its own cost, not on the respawn's.

On a CUDA configuration every worker is pinned to a card of its own
(``CUDA_VISIBLE_DEVICES`` set before the worker touches CUDA), one worker
per card: workers sharing a card would run inside each other's CUDA-event
windows. Workers are spawned, never forked (a CUDA context does not survive
``fork``).

:class:`SubprocessRunner` packages the pool as a :class:`~repro_torch.core.
runner`-protocol runner: each candidate is built **and** timed inside a
worker, by ``CudaRunner`` on the worker's card for a configuration that
runs on the card and by ``EmulateRunner`` otherwise (``CPU_EMULATE``,
``INTERPRET``), so it is a drop-in replacement for either, with kill
semantics. Timeouts, crashes and faults surface as ``INVALID`` latencies,
exactly like an invalid candidate does.
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing as mp
import multiprocessing.connection
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Sequence

from repro_torch.core.hardware import HardwareConfig, check_device, on_card
from repro_torch.core.runner import INVALID
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class TaskOutcome:
    """Result of one pool task.

    ``status`` is one of:
      - ``"ok"``      — task returned; ``value`` holds the result;
      - ``"error"``   — task raised; worker survived; ``error`` holds repr;
      - ``"timeout"`` — task exceeded the deadline; worker was killed;
      - ``"crash"``   — worker process died mid-task, or the task faulted
        on the card and the worker exited (respawned either way).
    """

    status: str
    value: Any = None
    error: str | None = None
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _poisons_context(exc: BaseException) -> bool:
    """True when ``exc`` may have left this process's CUDA context unusable:
    a kernel launch that failed for any reason but a refusal, or a CUDA
    error torch raised (``torch.AcceleratorError``, ``torch.cuda.CudaError``)
    — decided by type, never by message text."""
    from repro_torch.kernels._build import KernelLaunchError

    if isinstance(exc, KernelLaunchError):
        return not exc.refused
    torch = sys.modules.get("torch")
    if torch is None:  # nothing in this worker can have touched CUDA
        return False
    return isinstance(exc, (torch.AcceleratorError, torch.cuda.CudaError))


def _worker_loop(conn, task: Callable[[Any], Any],
                 initializer: Callable[[], None] | None = None,
                 card: str | None = None) -> None:
    """Worker-process main: pin to ``card`` (a ``CUDA_VISIBLE_DEVICES``
    entry, before anything touches CUDA), initialize, signal readiness,
    then recv payload, run task, send outcome, repeat. A task error that
    poisons the CUDA context is sent as ``"fatal"`` and ends the worker."""
    try:
        if card is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = card
        if initializer is not None:
            initializer()
        conn.send(("ready", os.getpid()))
    except BaseException:
        return  # parent sees EOF / a missing ready and retires the worker
    while True:
        try:
            payload = conn.recv()
        except (EOFError, OSError):
            return
        try:
            result = task(payload)
        except BaseException as e:  # task errors must not kill the worker
            fatal = _poisons_context(e)
            try:
                conn.send(("fatal" if fatal else "error",
                           f"{type(e).__name__}: {e}"))
            except (BrokenPipeError, OSError):
                return
            if fatal:
                return  # the parent retires and respawns this slot
        else:
            try:
                conn.send(("ok", result))
            except (BrokenPipeError, OSError):
                return


class _Worker:
    """One persistent worker process plus its parent-side pipe end."""

    def __init__(self, ctx, task: Callable[[Any], Any],
                 initializer: Callable[[], None] | None = None,
                 card: str | None = None):
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(target=_worker_loop,
                                args=(child, task, initializer, card),
                                daemon=True)
        self.proc.start()
        child.close()
        self.ready = False
        self.dead = False

    def wait_ready(self, timeout_s: float) -> bool:
        """Consume the worker's ready signal if it has arrived (or arrives
        within ``timeout_s``). Spawn/import cost is paid before the signal,
        *outside* any task deadline. Sets ``dead`` if the worker died while
        initializing (distinguishes "not yet" from "never")."""
        if self.ready:
            return True
        try:
            if self.conn.poll(timeout_s):
                msg = self.conn.recv()
                self.ready = isinstance(msg, tuple) and msg[0] == "ready"
                if not self.ready:
                    self.dead = True  # protocol violation: don't trust it
        except (EOFError, OSError):
            self.dead = True
        return self.ready

    def kill(self) -> None:
        """Hard stop; safe to call repeatedly and concurrently with
        ``close`` (kill/close on an already-dead process or an
        already-closed pipe are no-ops)."""
        try:
            self.proc.kill()
            self.proc.join(timeout=5.0)
        except (ValueError, OSError, AssertionError):
            pass  # process already closed/reaped by a concurrent teardown
        finally:
            try:
                self.conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Graceful shutdown: closing the pipe EOFs the worker loop."""
        try:
            self.conn.close()
        except OSError:
            pass
        try:
            self.proc.join(timeout=1.0)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=5.0)
        except (ValueError, OSError, AssertionError):
            pass


class MeasurePool:
    """A fixed-size pool of persistent worker processes.

    ``task`` must be a module-level (picklable-by-reference) callable taking
    one payload argument; it is shipped to each worker once at spawn. The
    default ``mp_context`` is ``"spawn"`` — fork is unsafe once torch has
    started threads in the parent, and a CUDA context does not survive it.
    ``devices``, one card index per worker, pins slot ``i``'s worker (and
    every respawn of it) to card ``devices[i]``: the worker then sees that
    card alone, as ``cuda:0``.
    """

    def __init__(self, task: Callable[[Any], Any], workers: int = 1,
                 timeout_s: float = 60.0, mp_context: str = "spawn",
                 initializer: Callable[[], None] | None = None,
                 spawn_timeout_s: float = 300.0,
                 devices: Sequence[int] | None = None):
        self.task = task
        self.workers = max(1, int(workers))
        self.timeout_s = timeout_s
        self.initializer = initializer
        self.spawn_timeout_s = spawn_timeout_s
        self.ctx = mp.get_context(mp_context)
        if devices is not None and len(devices) != self.workers:
            raise ValueError(f"{len(devices)} devices for {self.workers} "
                             f"workers: pin one worker to each card")
        self._cards = ([_visible_id(d) for d in devices]
                       if devices is not None else [None] * self.workers)
        self._pool: list[_Worker | None] = [None] * self.workers
        self.restarts = 0  # workers killed (timeout) or lost (crash)
        # Worker-slot mutations (retire/launch/close) are serialized so that
        # close() — including the GC-driven __del__ path, which can run on
        # another thread while run_many is mid-respawn — can never interleave
        # with a respawn and leak the freshly-spawned worker.
        self._lock = threading.RLock()
        self._closed = False

    # ---- lifecycle -------------------------------------------------------------
    def _retire(self, i: int) -> None:
        with self._lock:
            w = self._pool[i]
            if w is not None:
                w.kill()
            self._pool[i] = None
            self.restarts += 1

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent, safe under concurrent kill/respawn: after the flag is
        set no slot can spawn a new worker, so nothing closed here can come
        back, and a racing ``run_many`` drains its remaining payloads as
        ``crash`` outcomes instead of touching retired slots."""
        with self._lock:
            self._closed = True
            for i, w in enumerate(self._pool):
                if w is not None:
                    w.close()
                self._pool[i] = None

    def __enter__(self) -> "MeasurePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- execution -------------------------------------------------------------
    def run_many(self, payloads: Sequence[Any]) -> list[TaskOutcome]:
        """Run every payload, ``workers`` at a time; results stay aligned
        with ``payloads``. Each task gets its own ``timeout_s`` deadline,
        which starts at dispatch to a *ready* worker — (re)spawns happen
        asynchronously (``booting`` slots), so neither the in-worker imports
        nor another slot's respawn is ever billed to a task's budget, and a
        respawn can never delay the deadline kill of a different worker."""
        payloads = list(payloads)
        outcomes: list[TaskOutcome | None] = [None] * len(payloads)
        if self._closed:
            return [TaskOutcome("crash", error="pool closed")
                    for _ in payloads]
        queue = deque(enumerate(payloads))
        active: dict[int, tuple[int, float, float]] = {}  # slot -> (idx, deadline, t0)
        booting: dict[int, float] = {}  # slot -> spawn deadline
        idle: deque[int] = deque()  # slots whose workers are ready
        spawn_fails = [0] * self.workers

        def launch(slot: int) -> None:
            """(Re)spawn slot's worker without blocking; give up on the slot
            after repeated spawn failures so a broken task/initializer can't
            respawn forever. Under the lifecycle lock (and a no-op once the
            pool is closed) so a concurrent close() can never race a respawn
            and strand the new worker."""
            with self._lock:
                if self._closed or spawn_fails[slot] >= 2:
                    return
                w = self._pool[slot]
                if w is not None:
                    w.kill()
                self._pool[slot] = _Worker(self.ctx, self.task,
                                           self.initializer,
                                           self._cards[slot])
                booting[slot] = time.monotonic() + self.spawn_timeout_s

        for slot in range(min(self.workers, len(payloads))):
            w = self._pool[slot]
            if w is not None and w.proc.is_alive() and not w.dead:
                if w.ready or w.wait_ready(0):
                    idle.append(slot)
                else:  # still booting from a previous call: keep waiting
                    booting[slot] = time.monotonic() + self.spawn_timeout_s
            else:
                launch(slot)

        def dispatch() -> None:
            while queue and idle and not self._closed:
                slot = idle.popleft()
                w = self._pool[slot]
                if w is None:  # slot torn down by a concurrent close()
                    continue
                idx, payload = queue.popleft()
                try:
                    w.conn.send(payload)
                except (BrokenPipeError, OSError):
                    # worker died between tasks: requeue, respawn the slot
                    queue.appendleft((idx, payload))
                    self._retire(slot)
                    launch(slot)
                    continue
                now = time.monotonic()
                active[slot] = (idx, now + self.timeout_s, now)

        dispatch()
        while queue or active:
            if self._closed:
                # a concurrent close() tore the workers down: drain instead
                # of touching retired slots (results for payloads already
                # dispatched are unknowable — their workers are gone)
                while queue:
                    idx, _ = queue.popleft()
                    outcomes[idx] = TaskOutcome("crash", error="pool closed")
                for idx, _, t0 in active.values():
                    outcomes[idx] = TaskOutcome(
                        "crash", elapsed_s=time.monotonic() - t0,
                        error="pool closed")
                active.clear()
                break
            if not active and not booting and not idle:
                # no worker running, coming up, or available: the remaining
                # payloads can never execute (spawns exhausted)
                while queue:
                    idx, _ = queue.popleft()
                    outcomes[idx] = TaskOutcome(
                        "crash", error="no pool worker could be started")
                break
            watch: dict = {}
            for slot in active:
                w = self._pool[slot]
                if w is not None:
                    watch[w.conn] = ("task", slot, w)
            for slot in booting:
                w = self._pool[slot]
                if w is not None:
                    watch[w.conn] = ("boot", slot, w)
            deadlines = ([dl for _, dl, _ in active.values()]
                         + list(booting.values()))
            wait_s = max(0.0, min(deadlines) - time.monotonic()) \
                if deadlines else None
            if watch:
                try:
                    ready = mp.connection.wait(list(watch), timeout=wait_s)
                except OSError:  # a pipe closed mid-wait (concurrent close)
                    ready = []
            else:  # every watched slot was retired under us; pace the loop
                time.sleep(min(0.05, wait_s if wait_s is not None else 0.05))
                ready = []
            for conn in ready:
                kind, slot, w = watch[conn]
                if kind == "boot":
                    if w.wait_ready(0):
                        booting.pop(slot)
                        spawn_fails[slot] = 0
                        idle.append(slot)
                    elif w.dead:  # died while initializing
                        booting.pop(slot)
                        self._retire(slot)
                        spawn_fails[slot] += 1
                        if queue:
                            launch(slot)
                    continue
                idx, _, t0 = active.pop(slot)
                elapsed = time.monotonic() - t0
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    outcomes[idx] = TaskOutcome("crash", elapsed_s=elapsed,
                                                error="worker died mid-task")
                    self._retire(slot)
                    if queue:
                        launch(slot)
                else:
                    if status == "fatal":
                        # the task faulted on the card and its worker exited:
                        # a crash, the slot respawned on a fresh context
                        outcomes[idx] = TaskOutcome("crash", error=value,
                                                    elapsed_s=elapsed)
                        self._retire(slot)
                        if queue:
                            launch(slot)
                        continue
                    if status == "ok":
                        outcomes[idx] = TaskOutcome("ok", value=value,
                                                    elapsed_s=elapsed)
                    else:
                        outcomes[idx] = TaskOutcome("error", error=value,
                                                    elapsed_s=elapsed)
                    idle.append(slot)
            now = time.monotonic()
            for slot in [s for s, (_, dl, _) in active.items() if dl <= now]:
                idx, _, t0 = active.pop(slot)
                outcomes[idx] = TaskOutcome("timeout", elapsed_s=now - t0,
                                            error=f"killed after "
                                                  f"{self.timeout_s:.1f}s")
                self._retire(slot)  # SIGKILL: a hung task cannot linger
                if queue:
                    launch(slot)
            for slot in [s for s, dl in booting.items() if dl <= now]:
                booting.pop(slot)
                self._retire(slot)
                spawn_fails[slot] += 1
                if queue:
                    launch(slot)
            dispatch()
        return [o if o is not None else TaskOutcome("crash", error="lost")
                for o in outcomes]


def _visible_id(device: int) -> str:
    """The ``CUDA_VISIBLE_DEVICES`` entry that shows a worker card
    ``device`` of this process (and only it)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return str(device)
    return visible.split(",")[device].strip()


def _cards_for(hw: HardwareConfig, workers: int, mp_context: str,
               device: int | None = None) -> list[int] | None:
    """The cards a pool measuring on ``hw`` pins its workers to, one worker
    per card: ``[device]``, or the first ``workers`` visible cards (every
    one for 0). None for a configuration that does not run on the card.
    Raises in the parent, before any worker is spawned: without a card (no
    CPU fallback), for a context other than spawn, for more workers than
    cards, and for a card that is not ``hw``."""
    if not on_card(hw):
        return None
    if mp_context != "spawn":
        raise ValueError(f"{hw.name} measures on a CUDA card: workers must "
                         f"be spawned, not {mp_context!r} (a CUDA context "
                         f"does not survive fork)")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"{hw.name} measures on a CUDA card and none is "
                           f"visible (CPU_EMULATE runs the plain versions)")
    visible = torch.cuda.device_count()
    cards = [device] if device is not None else list(range(workers or visible))
    if (device is not None and workers > 1) or max(cards) >= visible:
        raise ValueError(
            f"{workers} timing worker(s) on card(s) {cards} with {visible} "
            f"visible: one worker per card, since workers sharing a card "
            f"time inside each other's CUDA-event windows")
    for card in cards:
        check_device(hw, card)
    return cards


def _worker_warmup(hw: HardwareConfig | None = None) -> None:
    """Pool worker initializer: pay the heavy imports at spawn, before the
    worker signals ready, so a candidate's timeout budget covers only its
    own build + measurement. On the card (the worker sees only its own, as
    ``cuda:0``) also check it, build the kernels (a no-op when the build
    directory is complete) and bring the context up with a synchronize."""
    import torch

    from repro_torch import kernels  # noqa: F401

    if on_card(hw):
        from repro_torch.kernels import _build

        check_device(hw, 0)
        _build.build_all()
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def _initializer(hw: HardwareConfig, task: Callable[[Any], Any]):
    """The worker initializer a pool measuring on ``hw`` with ``task``
    needs: a worker on the card always warms its card up (whatever the
    task, it runs there); off the card only the real measurement task pays
    the imports, and a custom test task keeps its workers import-light."""
    if on_card(hw):
        return functools.partial(_worker_warmup, hw)
    return _worker_warmup if task is _measure_candidate else None


# A worker's card runners by (hw, repeats, warmup): a CudaRunner holds its
# timer's flush buffer and each workload's operands on the card, made once
# per worker process instead of once per candidate.
_CARD_RUNNERS: dict[tuple, Any] = {}


def _measure_candidate(payload) -> float:
    """Pool task: build + time one candidate inside the worker process.

    Runs the full runner path (concretize, kernel build, first run, timed
    repeats): ``CudaRunner`` on the worker's card for a configuration that
    runs on the card, ``EmulateRunner`` otherwise — so any hang or fault
    anywhere in that pipeline is the parent's to kill or respawn.
    """
    from repro_torch.core.runner import CudaRunner, EmulateRunner

    hw, workload, schedule, repeats, warmup = payload
    if not on_card(hw):
        return EmulateRunner(hw, repeats=repeats,
                             warmup=warmup).run(workload, schedule)
    key = (hw, repeats, warmup)
    if key not in _CARD_RUNNERS:
        _CARD_RUNNERS[key] = CudaRunner(hw, repeats=repeats, warmup=warmup)
    return _CARD_RUNNERS[key].run(workload, schedule)


@dataclasses.dataclass
class SubprocessRunner:
    """Runner-protocol wrapper over :class:`MeasurePool`.

    Candidates are measured in persistent worker processes with a hard
    per-candidate ``timeout_s``; a wedged, crashing or faulting candidate
    costs exactly one candidate (reported ``INVALID``) and one worker
    respawn. ``workers=0`` picks ``min(cpu_count, 4)`` off the card and one
    worker per visible card on it (each pinned to its card; more workers
    than cards raises). A configuration that runs on the card raises at
    construction when no card is visible. Call :meth:`close` (or use as a
    context manager) to release the workers.

    Because workers are persistent spawn processes, module state survives
    across tasks: each worker's process-wide
    :class:`~repro_torch.core.build_cache.BuildCache` warms up once per
    distinct kernel signature and serves every later candidate that
    concretizes to it — no parent-side plumbing needed. With ``dedup=True``,
    same-signature candidates within a batch are additionally collapsed
    *before* dispatch: each distinct signature is measured once and its
    latency fanned out by submission position. Off by default — reusing a
    measured latency for a duplicate is a semantic choice on a noisy runner
    (see ``runner.py``).
    """

    hw: HardwareConfig
    repeats: int = 3
    warmup: int = 1
    workers: int = 0
    timeout_s: float = 60.0
    mp_context: str = "spawn"
    dedup: bool = False
    name: str = "subprocess"
    # See tuner.py: runners with real measurement latency opt into the
    # pipelined (speculative) tuner loop.
    overlap_capable = True
    # MeasureScheduler capacity hint: run_batch is synchronous over one
    # pool, so submitted batches progress one at a time (the pool's own
    # workers parallelize *within* a batch). A farm of LocalBoards — each
    # wrapping its own MeasurePool — is the multi-inflight configuration.
    max_inflight = 1
    # test seam: replace the in-worker measurement task (must stay a
    # module-level callable so spawn can import it by reference)
    task: Callable[[Any], Any] = _measure_candidate

    def __post_init__(self):
        self._pool: MeasurePool | None = None
        self._cards = _cards_for(self.hw, self.workers, self.mp_context)

    def _ensure_pool(self) -> MeasurePool:
        if self._pool is None:
            n = (len(self._cards) if self._cards is not None
                 else self.workers or min(os.cpu_count() or 1, 4))
            self._pool = MeasurePool(self.task, workers=n,
                                     timeout_s=self.timeout_s,
                                     mp_context=self.mp_context,
                                     initializer=_initializer(self.hw,
                                                              self.task),
                                     devices=self._cards)
        return self._pool

    @property
    def pool_restarts(self) -> int:
        return self._pool.restarts if self._pool is not None else 0

    def run(self, workload: Workload, schedule: Schedule) -> float:
        return self.run_batch(workload, [schedule])[0]

    def run_batch(self, workload: Workload,
                  schedules: Sequence[Schedule]) -> list[float]:
        schedules = list(schedules)
        n = len(schedules)
        rep = list(range(n))
        if self.dedup:
            first: dict = {}
            for i, s in enumerate(schedules):
                rep[i] = first.setdefault(s.signature(), i)
        distinct = [i for i in range(n) if rep[i] == i]
        pool = self._ensure_pool()
        payloads = [(self.hw, workload, schedules[i], self.repeats,
                     self.warmup) for i in distinct]
        latencies = [INVALID] * n
        for i, o in zip(distinct, pool.run_many(payloads)):
            if o.ok and isinstance(o.value, (int, float)):
                latencies[i] = float(o.value)
        for i in range(n):
            if rep[i] != i:
                latencies[i] = latencies[rep[i]]
        return latencies

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "SubprocessRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
