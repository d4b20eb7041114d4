"""Dynamic function-call duration forecasting (paper §4.1, Eq. 1).

Per-function-type estimate lifecycle:
  no history  -> user's ``predict_time`` (graph metadata), else a
                 conservative system default;
  with history -> EWMA of observed durations, blended with the user
                 estimate: t = alpha * t_user + (1 - alpha) * t_history.

Alongside the mean, an EWMA of squared deviations tracks per-tool
dispersion, so schedulers can ask for a *quantile* of the duration
(``predict_interval``) instead of scaling the mean by a fixed safety
multiplier — a noisy tool gets a wide interval, a steady one a tight one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, Optional

_NORM = NormalDist()


@dataclass
class Forecaster:
    alpha: float = 0.3          # weight on the user estimate (Eq. 1)
    ewma_beta: float = 0.5      # EWMA smoothing for t_history
    default_time: float = 5.0   # conservative system-wide constant
    history: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    var: Dict[str, float] = field(default_factory=dict)   # EWMA of dev^2

    def predict(self, func_type: str,
                user_estimate: Optional[float] = None) -> float:
        t_hist = self.history.get(func_type)
        if t_hist is None:
            return user_estimate if user_estimate is not None \
                else self.default_time
        if user_estimate is None:
            return t_hist
        return self.alpha * user_estimate + (1 - self.alpha) * t_hist

    def observe(self, func_type: str, elapsed: float) -> None:
        prev = self.history.get(func_type)
        if prev is None:
            self.history[func_type] = elapsed
            self.var[func_type] = 0.0
        else:
            # deviation measured against the pre-update mean: one pass,
            # no second moment accumulator, mean math untouched
            dev = elapsed - prev
            self.var[func_type] = (self.ewma_beta * self.var[func_type]
                                   + (1 - self.ewma_beta) * dev * dev)
            self.history[func_type] = (self.ewma_beta * prev
                                       + (1 - self.ewma_beta) * elapsed)
        self.counts[func_type] = self.counts.get(func_type, 0) + 1

    def std(self, func_type: str) -> float:
        return self.var.get(func_type, 0.0) ** 0.5

    def n_obs(self, func_type: str) -> int:
        """Observations recorded for this stream — callers branch on
        cold start (0) vs priced history (e.g. a session's first
        turn-end must not trust the synthetic default gap's tight
        quantiles)."""
        return self.counts.get(func_type, 0)

    def predict_interval(self, func_type: str, q: float,
                         user_estimate: Optional[float] = None) -> float:
        """Quantile ``q`` of the tool's duration under a normal model
        around the Eq. 1 blend. With no dispersion history this degrades
        to ``predict`` exactly, so callers can use it unconditionally;
        the result is floored at 0 (durations are non-negative)."""
        mean = self.predict(func_type, user_estimate)
        s = self.std(func_type)
        if s <= 0.0 or q == 0.5:
            return mean
        return max(mean + s * _NORM.inv_cdf(q), 0.0)
