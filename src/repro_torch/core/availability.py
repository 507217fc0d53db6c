"""Learner-side availability forecasting (paper §4.1, App. A); the batched
``ForecasterBank`` of ``repro.core.availability``.

Each learner keeps an hour-of-day seasonal availability profile plus an
EWMA residual, learned from its own history, and answers the server's query
"P(available during [t+mu, t+2mu])?" from local data only.  All learners'
forecasters are held as (n, n_bins) count matrices and updated with batched
numpy operations, with the reference's formulas and evaluation order.  The
legacy engine (``SimConfig(fast_path=False)``) keeps one scalar
``AvailabilityForecaster`` a learner instead, the same model, whose float
order the bank reproduces element for element.
"""
from __future__ import annotations

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


class AvailabilityForecaster:
    """Online seasonal forecaster over hour-of-day bins with an EWMA residual."""

    def __init__(self, n_bins: int = 48, ewma_alpha: float = 0.05,
                 seasonal_weight: float = 0.9, prior: float = 0.5):
        self.n_bins = n_bins
        self.ewma_alpha = ewma_alpha
        self.seasonal_weight = seasonal_weight
        self.counts = np.ones(n_bins) * 2.0          # Beta(1,1)-ish smoothing
        self.avail_counts = np.ones(n_bins) * 2.0 * prior
        self.recent = prior

    def observe(self, t: float, available: bool):
        b = int((t % DAY) / DAY * self.n_bins) % self.n_bins
        self.counts[b] += 1.0
        self.avail_counts[b] += float(available)
        self.recent = ((1 - self.ewma_alpha) * self.recent
                       + self.ewma_alpha * float(available))

    def predict_window(self, t_start: float, t_end: float) -> float:
        """P(available throughout [t_start, t_end]) (Alg. 1's p_l)."""
        if t_end <= t_start:
            t_end = t_start + 1.0
        ts = np.linspace(t_start, t_end, 4)
        bins = ((ts % DAY) / DAY * self.n_bins).astype(int) % self.n_bins
        seasonal = float(np.mean(self.avail_counts[bins] / self.counts[bins]))
        return (self.seasonal_weight * seasonal
                + (1 - self.seasonal_weight) * self.recent)

    def score(self, trace_fn, t_eval: np.ndarray) -> dict:
        """Forecast accuracy against the ground truth ``trace_fn(t)`` at the
        times ``t_eval``: R^2 (NaN for a constant truth), MSE, MAE."""
        preds = np.array([self.predict_window(t, t + HOUR / 2) for t in t_eval])
        truth = np.array([float(trace_fn(t)) for t in t_eval])
        mse = float(np.mean((preds - truth) ** 2))
        mae = float(np.mean(np.abs(preds - truth)))
        var = float(np.var(truth))
        r2 = float("nan") if var == 0.0 else 1.0 - mse / var
        return {"r2": r2, "mse": mse, "mae": mae}


class ForecasterBank:
    def __init__(self, n: int, n_bins: int = 48, ewma_alpha: float = 0.05,
                 seasonal_weight: float = 0.9, prior: float = 0.5):
        self.n = n
        self.n_bins = n_bins
        self.ewma_alpha = ewma_alpha
        self.seasonal_weight = seasonal_weight
        self.counts = np.full((n, n_bins), 2.0)
        self.avail_counts = np.full((n, n_bins), 2.0 * prior)
        self.recent = np.full(n, prior)

    def _bin(self, t: float) -> int:
        return int((t % DAY) / DAY * self.n_bins) % self.n_bins

    def observe_batch(self, lids, t: float, available):
        """One observation at time ``t`` for each learner in ``lids``
        (unique within a call: fancy-index assignment applies one step to a
        duplicated lid)."""
        lids = np.asarray(lids)
        avail = np.broadcast_to(np.asarray(available, float), lids.shape)
        b = self._bin(t)
        self.counts[lids, b] += 1.0
        self.avail_counts[lids, b] += avail
        self.recent[lids] = ((1 - self.ewma_alpha) * self.recent[lids]
                             + self.ewma_alpha * avail)

    def observe_all(self, t: float, available):
        """Observation for every learner at once (warmup / census paths)."""
        avail = np.asarray(available, float)
        b = self._bin(t)
        self.counts[:, b] += 1.0
        self.avail_counts[:, b] += avail
        self.recent = (1 - self.ewma_alpha) * self.recent + self.ewma_alpha * avail

    def predict_window_batch(self, lids, t_start: float, t_end: float):
        """P(available throughout [t_start, t_end]) per queried learner."""
        lids = np.asarray(lids)
        if t_end <= t_start:
            t_end = t_start + 1.0
        ts = np.linspace(t_start, t_end, 4)
        bins = ((ts % DAY) / DAY * self.n_bins).astype(int) % self.n_bins
        ratios = (self.avail_counts[np.ix_(lids, bins)]
                  / self.counts[np.ix_(lids, bins)])
        seasonal = ratios.mean(axis=1)
        return (self.seasonal_weight * seasonal
                + (1 - self.seasonal_weight) * self.recent[lids])

    def view(self, lid: int) -> "ForecasterView":
        return ForecasterView(self, lid)


class ForecasterView:
    """Scalar ``AvailabilityForecaster``-compatible facade over one bank row."""

    __slots__ = ("bank", "lid", "_lid_arr")

    def __init__(self, bank: ForecasterBank, lid: int):
        self.bank = bank
        self.lid = lid
        self._lid_arr = np.array([lid])

    def observe(self, t: float, available: bool):
        self.bank.observe_batch(self._lid_arr, t, float(available))

    def predict_window(self, t_start: float, t_end: float) -> float:
        return float(self.bank.predict_window_batch(self._lid_arr,
                                                    t_start, t_end)[0])

    score = AvailabilityForecaster.score
