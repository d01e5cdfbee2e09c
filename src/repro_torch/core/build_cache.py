"""Content-addressed cache of built kernel callables.

``kernels.build`` is a pure function of the concrete
:class:`~repro_torch.core.space.KernelParams` and the backend ("cuda" or
"plain"): nothing in the built callable depends on which schedule trace or
tuning run asked for it. This module gives that purity a cache.

:class:`BuildCache` is a bounded per-process LRU keyed by
``(params.signature(), backend)`` — a *content* key (value-derived, never
``id()`` or a default ``repr``), so two different schedule objects that
concretize to the same lowering share one built callable. One
process-wide instance (:func:`global_build_cache`) backs
``repro_torch.kernels.build`` by default, so the runners and dispatch hit
it without per-layer wiring. (The CUDA sources themselves are compiled
once per process and content-hashed on disk; see ``kernels/_build.py``.)

Counters (hits/misses/evictions) surface through ``TuneResult.build_cache``.
The cache never changes what a build returns — only whether the builder
runs — so fixed-seed tuning histories are bit-identical with it enabled.
:func:`clear_build_cache` exists for tests and for bounding memory.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable

DEFAULT_CAPACITY = 128


class BuildCache:
    """Bounded thread-safe LRU of built kernel callables.

    Keys must be hashable content signatures (``KernelParams.signature()``
    plus whatever flags the build depends on). The builder runs *outside*
    the lock — builds are slow and must not serialize unrelated lookups —
    so two threads racing on the same key may both build; the second
    insert wins and the loser's callable is simply dropped (benign: both
    are equal by construction).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Any | None:
        """The cached value for ``key`` (refreshing recency), or None.
        Does not count as a hit/miss — use :meth:`get_or_build` for the
        counted path."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            return None

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def get_or_build(self, key, builder: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building (and caching) it
        on a miss. Exceptions from ``builder`` propagate and cache
        nothing, so a crashing build is retried next time."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
        value = builder()  # outside the lock: builds are slow
        with self._lock:
            self.misses += 1
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Counter snapshot: hits/misses/evictions/size/capacity."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "capacity": self.capacity}

    def clear(self) -> None:
        """Drop every entry and reset the counters."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0

    def __repr__(self):
        s = self.stats()
        return (f"BuildCache(size={s['size']}/{s['capacity']}, "
                f"hits={s['hits']}, misses={s['misses']}, "
                f"evictions={s['evictions']})")


_GLOBAL = BuildCache()


def global_build_cache() -> BuildCache:
    """The process-wide cache backing ``repro_torch.kernels.build``."""
    return _GLOBAL


def build_cache_stats() -> dict:
    """Counter snapshot of the process-wide cache (the ``TuneResult``
    feed)."""
    return _GLOBAL.stats()


def clear_build_cache() -> None:
    """Drop the process-wide cache (tests / explicit memory bound)."""
    _GLOBAL.clear()


def stats_delta(after: dict, before: dict) -> dict:
    """Counter delta between two :func:`build_cache_stats` snapshots —
    what one tuning run / farm session contributed. Size/capacity report
    the ``after`` state (they are levels, not counters)."""
    out = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("hits", "misses", "evictions")}
    out["size"] = after.get("size", 0)
    out["capacity"] = after.get("capacity", 0)
    return out
