"""Tuning-record database.

Persists every measured (workload, hardware, schedule, latency) record and
answers best-schedule lookups. This is the deployable artifact of a tuning
run — the analogue of the tuned TVM module the paper ships to the board:
after tuning once per hardware config, the framework dispatches every matching
op through the stored best schedule with no further search.

Beyond exact lookups the database answers *transfer* queries
(:meth:`transfer_candidates`): the best schedules recorded for the same op
family on other shapes or hardware configs, used to warm-start new searches
(the paper's Fig. 4 schedule-transfer experiment), and stores session-level
latency/speedup summaries from :class:`repro_torch.core.session.TuningSession`.

Searches also persist their **learned proposal posteriors** (the per-decision
:class:`~repro_torch.core.space.DecisionDistribution` evidence, serialized under an
optional ``"dist"`` payload block — v2 databases without it stay loadable).
:meth:`transfer_distributions` is the distribution-level sibling of
:meth:`transfer_candidates`: it blends the stored posteriors of same-op-family
records, closest shape first, into ``{decision: {value: weight}}`` priors a
new search seeds its program with (Fig. 4 transfer upgraded from warm-start
traces to warm-start distributions).

The database doubles as a **cross-session re-measure memo**
(:meth:`TuningDatabase.measured_latency`): lookups keyed by (record key,
schedule signature) let a tuning session reuse the stored latency of a
concretization it already measured in an earlier session — at equal
fidelity only (same runner name) — instead of paying the build + run
again. Off by default at the consumer (``tune(reuse_measured=...)``).

Incoming data is **statically screened** (``core/static_analysis.py``):
``load`` verifies every record against the feasible table of its own
(workload, hardware) space and quarantines stale ones — values no longer in
any postprocessor-valid completion — instead of crashing or silently
warm-starting searches from garbage (see :attr:`TuningDatabase.quarantined`);
``transfer_candidates`` / ``transfer_distributions`` apply the same screen at
query time so post-load additions are covered too.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any

from repro_torch.core import hardware as hw_lib
from repro_torch.core import space as space_lib
from repro_torch.core import static_analysis as static_lib
from repro_torch.core.schedule import Schedule
from repro_torch.core.space import DecisionDistribution
from repro_torch.core.workload import Workload


class TuningDatabase:
    def __init__(self, path: str | None = None):
        self.path = path
        # key -> list of {schedule, latency, runner}
        self.records: dict[str, list[dict[str, Any]]] = {}
        self.workloads: dict[str, dict] = {}
        # session-level summaries, append-only (see TuningSession)
        self.sessions: list[dict[str, Any]] = []
        # key -> {decision_name: serialized DecisionDistribution} — the
        # learned proposal posteriors of the last search on that key
        self.distributions: dict[str, dict[str, dict]] = {}
        # key -> [{"record": ..., "reason": ...}] — loaded records the
        # static analyzer proved can no longer complete into a valid
        # schedule of their own (workload, hardware) space (stale space
        # version, foreign variant, hand-edited file). Kept out of best()/
        # transfer/warm-start but preserved across save() for forensics.
        self.quarantined: dict[str, list[dict]] = {}
        self.stale_quarantined = 0  # records quarantined by load()
        # memoized best() lookups (serving-path dispatch cache): key ->
        # (Schedule, latency) | None, invalidated per-key by add() and
        # wholesale by load(). Schedules are immutable, so sharing the
        # cached instance across callers is safe.
        self._best_cache: dict[str, tuple[Schedule, float] | None] = {}
        # memoized nearest_tuned() lookups (dynamic-shape bucketing in the
        # serving path): (key, hw_name) -> (Schedule, latency, source key)
        # | None. Any add()/load() can change which bucket is nearest, so
        # both clear it wholesale.
        self._bucket_cache: dict[
            tuple[str, str], tuple[Schedule, float, str] | None] = {}
        # signature-keyed measured-latency index (cross-session re-measure
        # memo): (record key, schedule signature) -> {runner: min latency}.
        # Built lazily by measured_latency(), invalidated to None on add()/
        # load()/quarantine like the bucket cache.
        self._measured_index: dict[
            tuple[str, tuple], dict[str, float]] | None = None
        self.measured_memo = 0  # measured_latency() hits
        if path and os.path.exists(path):
            self.load(path)

    @staticmethod
    def record_key(workload: Workload, hw_name: str) -> str:
        return f"{workload.key()}@{hw_name}"

    # ---- updates ---------------------------------------------------------------
    def add(self, workload: Workload, hw_name: str, schedule: Schedule,
            latency_s: float, runner_name: str) -> None:
        # Non-finite latencies (failed/invalid candidates) carry no
        # information and would break strict-JSON persistence ("Infinity" is
        # not JSON); reject them here so no caller needs to filter.
        if not math.isfinite(latency_s):
            return
        key = self.record_key(workload, hw_name)
        self.workloads[key] = workload.to_json()
        entry = {
            "schedule": schedule.to_json(),
            "latency_s": latency_s,
            "runner": runner_name,
        }
        bucket = self.records.setdefault(key, [])
        # Duplicates add no information but accrete without bound when
        # warm-started sessions re-measure deterministic records. Dedup on
        # semantic identity (decision signature + latency + runner), not raw
        # JSON: the same schedule serializes differently across trace
        # versions and provenance tags (e.g. re-adopted warm-start traces).
        sig = schedule.signature()
        for r in bucket:
            if (r["latency_s"] == latency_s and r["runner"] == runner_name
                    and Schedule.from_json(r["schedule"]).signature() == sig):
                return
        bucket.append(entry)
        self._best_cache.pop(key, None)
        self._bucket_cache.clear()
        self._measured_index = None

    def add_session(self, summary: dict[str, Any]) -> None:
        """Append one session-level summary (latency/speedup per model).
        Non-finite floats (e.g. a NaN speedup when nothing tuned) are
        sanitized to ``None`` so the stored payload stays strict JSON."""
        self.sessions.append(_json_sanitize(dict(summary)))

    def set_distributions(self, workload: Workload, hw_name: str,
                          dists: dict[str, dict]) -> None:
        """Store (replace) the learned proposal posteriors of one search —
        ``{decision_name: DecisionDistribution.to_json()}``. Later searches
        on the key overwrite: the posterior already folds prior evidence in
        (a warm-started search seeds from it and keeps accumulating)."""
        if not dists:
            return
        key = self.record_key(workload, hw_name)
        self.workloads[key] = workload.to_json()
        self.distributions[key] = _json_sanitize(dists)

    def get_distributions(self, workload: Workload,
                          hw_name: str) -> dict[str, dict]:
        """Stored proposal posteriors of one key ({} if never recorded)."""
        return self.distributions.get(self.record_key(workload, hw_name), {})

    # ---- queries ---------------------------------------------------------------
    def best(self, workload: Workload,
             hw_name: str) -> tuple[Schedule, float] | None:
        """Best record for (workload, hardware); memoized per key so hot
        serving-path dispatch is O(1) instead of re-scanning and re-parsing
        ``Schedule.from_json`` on every call."""
        key = self.record_key(workload, hw_name)
        if key in self._best_cache:
            return self._best_cache[key]
        # math.isfinite, not "!= inf": json.load accepts -Infinity, and a
        # -inf latency from a hand-edited or corrupted file would win every
        # min() forever (load() quarantines these, but records can also be
        # injected post-load).
        recs = [r for r in self.records.get(key, ())
                if math.isfinite(r["latency_s"])]
        if not recs:
            result = None
        else:
            top = min(recs, key=lambda r: r["latency_s"])
            result = (Schedule.from_json(top["schedule"]), top["latency_s"])
        self._best_cache[key] = result
        return result

    def history(self, workload: Workload, hw_name: str) -> list[dict]:
        return list(self.records.get(self.record_key(workload, hw_name), ()))

    def measured_latency(self, workload: Workload, hw_name: str,
                         schedule: Schedule,
                         runner_name: str | None = None) -> float | None:
        """Cross-session re-measure memo: the best recorded latency for this
        exact concretization — keyed by (record key, schedule signature) —
        or None if the database has never measured it.

        ``runner_name`` restricts the lookup to records measured by a runner
        of the same name, so a memo hit is always at *equal* fidelity
        (an analytic estimate must never stand in for a board measurement);
        ``None`` accepts any runner's record (callers who don't care, e.g.
        reporting). The index is built lazily from the full record set and
        invalidated by :meth:`add`/:meth:`load`/quarantine exactly like the
        bucket cache; hits count in :attr:`measured_memo`."""
        if self._measured_index is None:
            index: dict[tuple[str, tuple], dict[str, float]] = {}
            for key, recs in self.records.items():
                for r in recs:
                    lat = r.get("latency_s")
                    if not isinstance(lat, (int, float)) \
                            or not math.isfinite(lat):
                        continue
                    try:
                        sig = Schedule.from_json(r["schedule"]).signature()
                    except Exception:
                        continue  # malformed record: no memo entry
                    per_runner = index.setdefault((key, sig), {})
                    runner = r.get("runner", "")
                    if lat < per_runner.get(runner, math.inf):
                        per_runner[runner] = lat
            self._measured_index = index
        ikey = (self.record_key(workload, hw_name), schedule.signature())
        per_runner = self._measured_index.get(ikey)
        if not per_runner:
            return None
        if runner_name is None:
            lat = min(per_runner.values())
        else:
            lat = per_runner.get(runner_name)
            if lat is None:
                return None
        self.measured_memo += 1
        return lat

    def transfer_candidates(self, workload: Workload, hw_name: str,
                            limit: int = 4) -> list[Schedule]:
        """Warm-start schedules for a new search, best-first.

        Ranking: exact (workload, hardware) records first — a prior session's
        result for this very key — then the best record of every other
        (shape, hardware) entry of the same op family, closest shape first
        (Fig. 4: near-miss schedules transfer, far ones don't). Foreign
        schedules that don't concretize on the new target are filtered by the
        tuner, not here.
        """
        exact_key = self.record_key(workload, hw_name)
        # (distance, latency, key, best-record); the unique key tiebreaks
        # before the dict so sort never compares records.
        scored: list[tuple[float, float, str, dict]] = []
        for key, recs in self.records.items():
            wl_json = self.workloads.get(key)
            if wl_json is None or wl_json.get("op") != workload.op:
                continue
            finite = [r for r in recs
                      if math.isfinite(r["latency_s"])]
            # static screen against the source key's own space: a record
            # added after load() (or never loaded) could still be stale,
            # and a stale trace must not warm-start the new search
            report = self._static_report_for_key(key)
            if report is not None and finite:
                screened = []
                for r in finite:
                    try:
                        ok = not report.check_schedule(
                            Schedule.from_json(r["schedule"]))
                    except Exception:
                        ok = False
                    if ok:
                        screened.append(r)
                finite = screened
            if not finite:
                continue
            if key == exact_key:
                distance = -1.0  # always first
            else:
                distance = _shape_distance(workload.dims,
                                           tuple(wl_json.get("dims", ())))
            # rank mismatch -> infinite distance: such schedules can never
            # concretize on the target and would only pad out the warm-start
            # limit (mirrors the transfer_distributions skip)
            if math.isinf(distance):
                continue
            best = min(finite, key=lambda r: r["latency_s"])
            scored.append((distance, best["latency_s"], key, best))
        scored.sort(key=lambda t: t[:3])
        out: list[Schedule] = []
        seen: set[tuple] = set()
        for _, _, _, rec in scored:
            s = Schedule.from_json(rec["schedule"])
            if s.signature() not in seen:
                seen.add(s.signature())
                out.append(s)
            if len(out) >= limit:
                break
        return out

    def transfer_distributions(self, workload: Workload, hw_name: str,
                               limit: int = 4) -> dict[str, dict[Any, float]]:
        """Blended proposal priors for a new search — the distribution-level
        sibling of :meth:`transfer_candidates`.

        The stored posteriors of up to ``limit`` same-op-family keys are
        blended, closest shape first (exact key always leads), each source
        normalized then weighted by ``1 / (1 + shape_distance)`` so near-miss
        evidence dominates far evidence. Returns ``{decision_name: {value:
        weight}}``, ready for :meth:`SpaceProgram.seed_priors`; values the
        new program never offers simply never match a candidate set."""
        exact_key = self.record_key(workload, hw_name)
        scored: list[tuple[float, str, dict]] = []
        for key, dists in self.distributions.items():
            if not dists:
                continue
            wl_json = self.workloads.get(key)
            if wl_json is None or wl_json.get("op") != workload.op:
                continue
            if key == exact_key:
                distance = -1.0  # always first
            else:
                distance = _shape_distance(workload.dims,
                                           tuple(wl_json.get("dims", ())))
            if math.isinf(distance):
                continue
            scored.append((distance, key, dists))
        scored.sort(key=lambda t: t[:2])
        out: dict[str, dict[Any, float]] = {}
        for distance, key, dists in scored[:limit]:
            source_w = 1.0 / (1.0 + max(distance, 0.0))
            # statically-dead values of the source's own space carry no
            # transferable evidence (a stale posterior would bias the new
            # search toward candidates that can never validate)
            report = self._static_report_for_key(key)
            for name, blob in dists.items():
                d = DecisionDistribution.from_json(blob)
                values = tuple(sorted(d.mass, key=str))
                if not values:
                    continue
                # blend each source's normalized posterior (smoothed mean
                # rewards), not raw mass — frequency must not leak in
                tgt = out.setdefault(name, {})
                for v, score in zip(values, d.weights(values)):
                    if report is not None and not report.is_feasible(name, v):
                        continue
                    tgt[v] = tgt.get(v, 0.0) + source_w * score
        return out

    def nearest_tuned(self, workload: Workload, hw: "hw_lib.HardwareConfig",
                      ) -> tuple[Schedule, float, str] | None:
        """Nearest tuned *bucket* for an unseen serving shape — the best
        record of the closest same-op shape on the same hardware whose
        schedule concretizes valid on the actual workload.

        This is the serving-path sibling of :meth:`transfer_candidates`:
        where transfer seeds a *search* (any hardware, tuner re-validates),
        bucketing must hand back a schedule that is correct to run *right
        now*, so it is same-hardware only, skips infinite (cross-rank)
        distances, and concretizes each candidate on the actual shape before
        returning it — a bucket that doesn't concretize falls through to the
        next-nearest, and a total miss returns None (dispatch then drops to
        the fixed library). Results are memoized per (workload, hardware)
        and invalidated by add()/load(), so hot serving dispatch stays O(1).
        """
        exact_key = self.record_key(workload, hw.name)
        cache_key = (exact_key, hw.name)
        if cache_key in self._bucket_cache:
            return self._bucket_cache[cache_key]
        scored: list[tuple[float, float, str, dict]] = []
        for key, recs in self.records.items():
            if key == exact_key or not key.endswith("@" + hw.name):
                continue
            wl_json = self.workloads.get(key)
            if wl_json is None or wl_json.get("op") != workload.op:
                continue
            finite = [r for r in recs if math.isfinite(r["latency_s"])]
            if not finite:
                continue
            distance = _shape_distance(workload.dims,
                                       tuple(wl_json.get("dims", ())))
            if math.isinf(distance):
                continue
            best = min(finite, key=lambda r: r["latency_s"])
            scored.append((distance, best["latency_s"], key, best))
        scored.sort(key=lambda t: t[:3])
        result = None
        for distance, latency, key, rec in scored:
            schedule = Schedule.from_json(rec["schedule"])
            try:
                valid = space_lib.concretize(workload, hw, schedule).valid
            except Exception:
                valid = False
            if valid:
                result = (schedule, latency, key)
                break
        self._bucket_cache[cache_key] = result
        return result

    def __len__(self):
        return sum(len(v) for v in self.records.values())

    # ---- persistence --------------------------------------------------------------
    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no path configured")
        payload = {"records": self.records, "workloads": self.workloads,
                   "sessions": self.sessions, "dist": self.distributions,
                   "quarantine": self.quarantined}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
        try:
            with os.fdopen(fd, "w") as f:
                # strict JSON: add()/add_session() keep non-finite floats
                # out, so a failure here is a real serialization bug
                json.dump(payload, f, allow_nan=False)
            os.replace(tmp, path)  # atomic
        except BaseException:
            try:
                os.unlink(tmp)  # never leak the temp file on a failed write
            except OSError:
                pass
            raise

    def load(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        self.records = payload.get("records", {})
        self.workloads = payload.get("workloads", {})
        self.sessions = payload.get("sessions", [])
        self.distributions = payload.get("dist", {})  # optional: v2 payloads
        self.quarantined = payload.get("quarantine", {})
        self._best_cache.clear()
        self._bucket_cache.clear()
        self._measured_index = None
        self._sanitize_latencies()
        self._verify_records()

    def _sanitize_latencies(self) -> None:
        """Quarantine loaded records with non-finite or non-numeric
        latencies. ``save`` never writes them (strict JSON), but
        ``json.load`` happily parses ``Infinity``/``-Infinity``/``NaN``
        from a hand-edited file — and a ``-inf`` latency would win every
        best() min() forever if it reached the query paths."""
        for key in list(self.records):
            kept: list[dict] = []
            bad: list[dict] = []
            for rec in self.records[key]:
                lat = rec.get("latency_s")
                if isinstance(lat, (int, float)) and math.isfinite(lat):
                    kept.append(rec)
                else:
                    bad.append({"record": rec,
                                "reason": f"non-finite latency: {lat!r}"})
            if bad:
                self.records[key] = kept
                self.quarantined.setdefault(key, []).extend(bad)
                self.stale_quarantined += len(bad)

    # ---- static screening ----------------------------------------------------
    def _static_report_for_key(self, key: str):
        """Feasibility report for a record key's *own* (workload, hardware)
        space, or None when one can't be built (unknown hardware name, an
        op whose design space is not ported — ``space.UNPORTED_OPS``,
        attention only — malformed workload JSON) — verification is then
        skipped rather than guessed, so records the JAX package wrote for
        ops or hardware this package cannot analyse keep loading
        untouched. gemv and vmacc records are analysed like matmul's."""
        wl_json = self.workloads.get(key)
        if wl_json is None or "@" not in key:
            return None
        try:
            wl = Workload.from_json(wl_json)
            hw = hw_lib.get(key.rsplit("@", 1)[1])
            if wl.op in space_lib.UNPORTED_OPS:
                return None
            return static_lib.feasibility(wl, hw)
        except Exception:
            return None

    def _verify_records(self) -> None:
        """Quarantine loaded records the static analyzer proves stale.

        Each record is checked against the feasible table of its own key's
        space — a schedule whose decision values can no longer participate
        in any postprocessor-valid completion (the space definition moved,
        the variant was renamed, the file was hand-edited) would otherwise
        crash replay or silently warm-start searches from garbage. Such
        records move to :attr:`quarantined` with the provable reason;
        everything the analyzer can't decide stays in place."""
        for key in list(self.records):
            report = self._static_report_for_key(key)
            kept: list[dict] = []
            bad: list[dict] = []
            for rec in self.records[key]:
                try:
                    schedule = Schedule.from_json(rec["schedule"])
                    reason = (report.check_schedule(schedule)
                              if report is not None else "")
                except Exception as exc:
                    reason = f"malformed record: {exc}"
                if reason:
                    bad.append({"record": rec, "reason": reason})
                else:
                    kept.append(rec)
            if bad:
                self.records[key] = kept
                self.quarantined.setdefault(key, []).extend(bad)
                self.stale_quarantined += len(bad)
                self._best_cache.pop(key, None)
                self._bucket_cache.clear()
                self._measured_index = None


def _json_sanitize(x: Any) -> Any:
    """Replace non-finite floats with None so payloads stay strict JSON."""
    if isinstance(x, dict):
        return {k: _json_sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_sanitize(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _shape_distance(a: tuple[int, ...], b: tuple[int, ...]) -> float:
    """Log-space distance between two dim tuples; inf across ranks."""
    if len(a) != len(b):
        return float("inf")
    return sum(abs(math.log(max(x, 1)) - math.log(max(y, 1)))
               for x, y in zip(a, b))


_GLOBAL: TuningDatabase | None = None
# (st_mtime_ns, st_size) of the artifact at the time _GLOBAL last read it,
# or None when the file was absent — the hot-swap generation check.
_GLOBAL_STAT: tuple[int, int] | None = None


def default_db_path() -> str:
    """The resolved process-wide artifact path: REPRO_TUNING_DB when set,
    else the repo's ``tuned/database.json``."""
    return os.path.abspath(
        os.environ.get("REPRO_TUNING_DB",
                       os.path.join(os.path.dirname(__file__),
                                    "..", "..", "..", "tuned",
                                    "database.json")))


def _artifact_stat(path: str) -> tuple[int, int] | None:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def global_database() -> TuningDatabase:
    """Process-wide database; path overridable via REPRO_TUNING_DB.

    Both the env var and the artifact file itself are re-resolved on *every*
    call. Repointing REPRO_TUNING_DB at a new tuned artifact (serving
    reload, tests) takes effect on the next lookup instead of being pinned
    to the first value seen; a database file that appears or changes on disk
    *after* the first call — a tuning run saving mid-process, a
    continuous tuner shipping a new artifact —
    is detected by (mtime, size) and reloaded **in place**, so a running
    server hot-swaps to the new records without a restart and without
    anyone calling :func:`reset_global_database`. While the file is
    unchanged the same instance is returned (its memoized best/bucket
    caches intact), so steady-state dispatch costs one ``os.stat``."""
    global _GLOBAL, _GLOBAL_STAT
    path = default_db_path()
    stat = _artifact_stat(path)
    if _GLOBAL is None or _GLOBAL.path != path:
        _GLOBAL = TuningDatabase(path if stat is not None else None)
        _GLOBAL.path = path
        _GLOBAL_STAT = stat
    elif stat != _GLOBAL_STAT:
        if stat is not None:
            # appeared or changed: reload in place (load() drops the best/
            # bucket caches) so holders of the instance see the new records
            _GLOBAL.load(path)
        else:
            # artifact deleted out from under us: fall back to empty
            _GLOBAL = TuningDatabase()
            _GLOBAL.path = path
        _GLOBAL_STAT = stat
    return _GLOBAL


def reset_global_database() -> None:
    """Drop the cached process-wide database; the next ``global_database()``
    call re-reads the file from disk (tests / serving artifact reload).
    Also drops the dispatch-layer schedule caches so no stale schedule
    stays reachable through the old chain."""
    global _GLOBAL, _GLOBAL_STAT
    _GLOBAL = None
    _GLOBAL_STAT = None
    from repro_torch.core import dispatch  # local: dispatch imports this module
    dispatch.invalidate_dispatch_caches()
