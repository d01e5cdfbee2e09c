"""Spans and counters of the port: one tracer, kept in memory.

Spans are recorded only while recording is enabled (:func:`enable`); at
other times :func:`span` hands back one shared no-op context manager, which
reads no clock and records nothing. A recorded span costs two appends to
one in-memory log, its start and its end; :func:`collect` pairs them into
:class:`Span` s, hands back those that ended and forgets them, so a caller
that enables recording collects what it records. A span's times come from
``time.time_ns()``, the Unix epoch in nanoseconds, which is the host clock
of ``torch.profiler``'s events: spans fall on a device trace's timeline. A
span's parent is the innermost span open on its own thread when it started.
A span opened with ``cpu=True`` also reads its thread's CPU time
(``time.thread_time_ns()``), so that its length splits into the thread's
own work and the time it did not run: waiting for the interpreter lock, or
blocked.

Counters are always on: :func:`count` adds to an integer of its own
thread's, with no lock, and :func:`counters` sums every thread's. A count
that would make the host wait for the card is made only while recording
(:func:`recording`).

This module imports nothing of the package, so every layer may use it.
"""

from __future__ import annotations

import _thread
import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One recorded span. ``parent`` is the ``id`` of the span that was
    open on ``thread`` when this one started (None at the top); ``cpu_ns``
    the thread's CPU time inside it, for a span opened with ``cpu=True``
    (None otherwise)."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    thread: int
    attrs: dict
    cpu_ns: int | None = None


class _Off:
    """The span handed out while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _End:
    """The span handed out while recording: its exit logs the end of the
    innermost span open on the calling thread."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _log.append((_ident(), _now()))
        return False


class _EndCpu(_End):
    """As :class:`_End`, for a span that reads its thread's CPU time."""
    __slots__ = ()

    def __exit__(self, *exc):
        _log.append((_ident(), _now(), _cpu()))
        return False


OFF = _Off()
_END = _End()
_END_CPU = _EndCpu()

_enabled = False
# starts, (name, attrs, thread, ns, cpu ns or None), and ends, (thread, ns)
# or (thread, ns, cpu ns), in the order each thread logged them
_log: list[tuple] = []
_ident = _thread.get_ident
_now = time.time_ns
_cpu = time.thread_time_ns
_next_id = itertools.count(1).__next__
# each thread's spans open at the last collect(): (id, name, start, parent,
# attrs, cpu start)
_open: dict[int, list[tuple]] = {}
# each thread's counters, and every thread's table that ever counted
_local = threading.local()
_tables: list[dict[str, int]] = []


def span(name: str, cpu: bool = False, **attrs):
    """A context manager that records ``name`` over its body (``attrs``
    kept with it, and the thread's CPU time if ``cpu``) while recording is
    enabled, and the shared no-op :data:`OFF` otherwise. Use it only in a
    ``with`` statement: the span starts when this is called."""
    if not _enabled:
        return OFF
    if cpu:
        _log.append((name, attrs or None, _ident(), _now(), _cpu()))
        return _END_CPU
    _log.append((name, attrs or None, _ident(), _now(), None))
    return _END


def enable() -> None:
    global _enabled
    _enabled = True


def recording() -> bool:
    """Whether spans are being recorded: a count that costs a wait for the
    card is made only then."""
    return _enabled


def disable() -> None:
    """Stop recording; spans open now are still recorded when they end."""
    global _enabled
    _enabled = False


def collect() -> list[Span]:
    """The spans that ended since the last call, in the order they ended;
    forgets them. Spans still open are handed back by a later call."""
    # each step is atomic under the interpreter lock: what other threads
    # log meanwhile stays in the log for the next call
    n = len(_log)
    log = _log[:n]
    del _log[:n]
    out = []
    for event in log:
        if len(event) == 5:
            name, attrs, thread, start, cpu = event
            stack = _open.setdefault(thread, [])
            stack.append((_next_id(), name, start,
                          stack[-1][0] if stack else None, attrs or {}, cpu))
        else:
            thread, end = event[:2]
            sid, name, start, parent, attrs, cpu = _open[thread].pop()
            used = event[2] - cpu if len(event) == 3 else None
            out.append(Span(sid, name, start, end, parent, thread, attrs,
                            used))
    return out


def count(name: str, n: int = 1) -> None:
    try:
        table = _local.table
    except AttributeError:
        table = _local.table = {}
        _tables.append(table)
    table[name] = table.get(name, 0) + n


def counters() -> dict[str, int]:
    total: dict[str, int] = {}
    for table in list(_tables):
        for name, n in table.copy().items():
            total[name] = total.get(name, 0) + n
    return total


def reset_counters(prefix: str = "") -> None:
    """Zero every counter whose name starts with ``prefix``; a count made
    on another thread meanwhile may survive."""
    for table in list(_tables):
        for name in list(table):
            if name.startswith(prefix):
                table[name] = 0
