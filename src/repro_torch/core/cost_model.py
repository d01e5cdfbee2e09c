"""Learned cost model guiding the evolutionary search.

MetaSchedule trains an XGBoost model on schedule features to rank unmeasured
candidates. We implement the same role with an online ridge regression on
hand-rolled schedule/workload features (dependency-free, deterministic).
The model predicts log-latency; before enough measurements exist it reports
itself unfitted and the tuner falls back to pure sampling, matching
MetaSchedule's warm-up phase.

Updates accumulate the Xᵀ X / Xᵀ y sufficient statistics instead of storing
every sample and refitting from scratch: one ``update`` costs O(d²) and the
d×d solve is deferred to the next ``predict`` after new evidence arrives, so
per-sample cost stays flat over a whole tuning session instead of growing
O(n·d²) with history length. Features are computed from the schedule's real
tile-split factors (block shapes, grid extents) — the quantities the
generative space program actually samples.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch import tracing
from repro_torch.core import space as space_lib
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.workload import Workload


def features(workload: Workload, hw: HardwareConfig,
             params: space_lib.KernelParams) -> np.ndarray:
    """~18-dim feature vector for one concrete schedule, from the real
    split factors the program sampled."""
    flops = workload.flops()
    traffic = space_lib.hbm_traffic_bytes(workload, params)
    steps = float(np.prod(params.grid))
    block_elems = float(np.prod(params.block))
    mxu = hw.mxu_dim
    bm = params.block[0]
    bn = params.block[1] if len(params.block) > 1 else 1
    bk = params.block[2] if len(params.block) > 2 else bn
    pad_waste = (float(np.prod(params.padded_dims[-3:]))
                 / max(float(np.prod(workload.dims[-3:])), 1.0))
    f = [
        math.log1p(flops),
        math.log1p(traffic),
        math.log1p(steps),
        math.log1p(block_elems),
        math.log1p(params.vmem_bytes),
        params.vmem_bytes / hw.vmem_capacity,
        min(bm, mxu) / mxu,
        min(bn, mxu) / mxu,
        min(bk, mxu) / mxu,
        1.0 if params.accumulate else 0.0,
        1.0 if params.order in ("mnk", "qk", "rc", "nk") else 0.0,
        math.log1p(flops / max(traffic, 1.0)),  # arithmetic intensity
        pad_waste,
        1.0 if bm % 8 == 0 else 0.0,
        1.0 if bn % 128 == 0 else 0.0,
        # real split factors: reduction-axis trip count (store-traffic
        # interplay) and output-tile aspect ratio
        math.log1p(float(params.grid[-1])),
        min(bm, bn) / max(bm, bn, 1),
        1.0,
    ]
    return np.asarray(f, dtype=np.float64)


class RidgeCostModel:
    """Online ridge regression on log-latency via sufficient statistics.

    ``update`` is O(d²) (accumulate Σx, Σxxᵀ, Σxy, Σy); the O(d³) solve —
    standardized, exactly the batch refit the model used to run per sample —
    happens lazily on the first ``predict`` after new evidence.
    """

    MIN_SAMPLES = 8

    def __init__(self, l2: float = 1e-3):
        self.l2 = l2
        self.n = 0
        self._sum_x: np.ndarray | None = None
        self._xtx: np.ndarray | None = None
        self._xty: np.ndarray | None = None
        self._sum_y = 0.0
        self._w: np.ndarray | None = None
        self._dirty = False

    @property
    def fitted(self) -> bool:
        return self.n >= self.MIN_SAMPLES

    def update(self, feats: np.ndarray, latency_s: float) -> None:
        if not np.isfinite(latency_s) or latency_s <= 0:
            return
        x = np.asarray(feats, dtype=np.float64)
        y = math.log(latency_s)
        if self._sum_x is None:
            d = x.shape[0]
            self._sum_x = np.zeros(d)
            self._xtx = np.zeros((d, d))
            self._xty = np.zeros(d)
        self.n += 1
        self._sum_x += x
        self._xtx += np.outer(x, x)
        self._xty += x * y
        self._sum_y += y
        self._dirty = True

    def _refit(self) -> None:
        n = float(self.n)
        mu = self._sum_x / n
        var = np.maximum(np.diag(self._xtx) / n - mu * mu, 0.0)
        sd = np.sqrt(var) + 1e-9
        ymean = self._sum_y / n
        # centered moments from the sufficient statistics:
        #   Σ(x-μ)(x-μ)ᵀ = XᵀX - n μμᵀ ;  Σ(x-μ)(y-ȳ) = Xᵀy - ȳ Σx
        a_c = self._xtx - n * np.outer(mu, mu)
        b_c = self._xty - ymean * self._sum_x
        d = self._sum_x.shape[0]
        a = a_c / np.outer(sd, sd) + self.l2 * np.eye(d)
        b = b_c / sd
        self._mu, self._sd, self._ymean = mu, sd, ymean
        self._w = np.linalg.solve(a, b)
        self._dirty = False

    def predict(self, feats: np.ndarray) -> float:
        """Predicted log-latency (lower is better)."""
        if not self.fitted:
            return 0.0
        if self._dirty or self._w is None:
            with tracing.span("cost_model.refit"):
                self._refit()
        xs = (np.asarray(feats, dtype=np.float64) - self._mu) / self._sd
        return float(xs @ self._w + self._ymean)

    def rank(self, feats_batch: list[np.ndarray]) -> np.ndarray:
        """Indices sorted by predicted latency, ascending."""
        preds = np.asarray([self.predict(f) for f in feats_batch])
        return np.argsort(preds, kind="stable")


def pretrain_from_database(model: RidgeCostModel, database,
                           hw: HardwareConfig) -> int:
    """Cold-start a cost model from a tuning database's measured records.

    Every finite-latency record measured on *this* hardware config — any
    workload, any op family — is replayed through ``features`` and folded
    into the model's sufficient statistics, so the first generations of a
    warm-database search are ranked by real evidence instead of an unfitted
    model's constant 0.0. Cross-hardware records are skipped: their
    latencies are not comparable and would mis-calibrate the fit. Returns
    the number of records folded in (deterministic: insertion order of the
    database's key/record lists).
    """
    suffix = "@" + hw.name
    n = 0
    for key, recs in database.records.items():
        if not key.endswith(suffix):
            continue
        wl_json = database.workloads.get(key)
        if wl_json is None:
            continue
        workload = Workload.from_json(wl_json)
        for rec in recs:
            latency = rec.get("latency_s")
            if latency is None or not math.isfinite(latency) or latency <= 0:
                continue
            schedule = _schedule_from_json(rec["schedule"])
            params = space_lib.concretize(workload, hw, schedule)
            if not params.valid:
                continue  # foreign-space record that doesn't lower here
            model.update(features(workload, hw, params), latency)
            n += 1
    return n


def _schedule_from_json(blob):
    from repro_torch.core.schedule import Schedule  # lazy: keep deps one-way
    return Schedule.from_json(blob)
