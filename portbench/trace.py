"""The traced part of a run: ``torch.profiler`` over a marked window, read
into device intervals and host events.

``traced()`` profiles the host (operators, runtime calls, the benchmark's
own ``record_function`` spans) and the card (kernels, copies, memsets), and
marks the window with a ``portbench.window`` span; :class:`Trace` then gives
the card's busy seconds within it, each kernel family's summed time, the
device operations that took most time, and the longest idle gaps by what
the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import re

WINDOW = "portbench.window"


@contextlib.contextmanager
def traced(ctx, holder: dict):
    """Profile the body as the traced window; ``holder["trace"]`` is the
    :class:`Trace` once the body has run. The card is synchronised before
    the window closes, so its work falls inside."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            ctx.sync()
    holder["trace"] = Trace.from_profile(prof, torch)


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


class Trace:
    def __init__(self, window: tuple[int, int], device: list, host: list):
        self.window = window             # (start ns, end ns)
        self.device = device             # [(start ns, end ns, name)]
        self.host = host                 # [(start ns, end ns, name)]
        self.window_s = (window[1] - window[0]) / 1e9

    @classmethod
    def from_profile(cls, prof, torch) -> "Trace":
        cuda = torch.autograd.DeviceType.CUDA
        window, device, host = None, [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            span = (start, start + e.duration_ns(), e.name())
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append(span)
            elif e.name() == WINDOW:
                window = span[:2]
            else:
                host.append(span)
        if window is None:
            raise RuntimeError("the trace holds no window span")
        lo, hi = window
        device = sorted(s for s in device if s[1] > lo and s[0] < hi)
        host = sorted(s for s in host if s[1] > lo and s[0] < hi)
        return cls(window, device, host)

    # ---- the card ----------------------------------------------------------
    def _merged(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        merged: list[list[int]] = []
        for start, end, _ in self.device:
            start, end = max(start, lo), min(end, hi)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card."""
        return sum(b - a for a, b in self._merged()) / 1e9

    def idle_share(self) -> float | None:
        if not self.device or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def operations(self, pattern: str | None = None) -> list[tuple]:
        """Device operations whose name matches ``pattern`` (all if None)."""
        if pattern is None:
            return list(self.device)
        rx = re.compile(pattern)
        return [s for s in self.device if rx.search(s[2])]

    def device_s(self, pattern: str) -> float:
        return sum(b - a for a, b, _ in self.operations(pattern)) / 1e9

    # ---- the breakdown -----------------------------------------------------
    def idle_gaps(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self._merged():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def gap_labels(self) -> dict[str, float]:
        """Idle seconds by the innermost host event that covers each gap's
        midpoint ("host: untraced" where none does: Python between
        operators)."""
        gaps = sorted(((a + b) // 2, b - a) for a, b in self.idle_gaps())
        starts = [s for s, _, _ in self.host]
        totals: dict[str, float] = {}
        open_: list[tuple[int, int, int, str]] = []   # (end, dur, start, name)
        i = 0
        for mid, length in gaps:
            j = bisect.bisect_right(starts, mid)
            for start, end, name in self.host[i:j]:
                heapq.heappush(open_, (end, end - start, start, name))
            i = j
            while open_ and open_[0][0] < mid:
                heapq.heappop(open_)
            label = min(open_, key=lambda e: e[1])[3] if open_ \
                else "host: untraced"
            totals[label] = totals.get(label, 0.0) + length / 1e9
        return totals

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for a, b, name in self.device:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gap_labels().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}
