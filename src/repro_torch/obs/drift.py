"""Predicted-vs-observed latency drift monitoring.

The closed calibration loop needs a signal: *are the
predictions this bank is serving still consistent with what the device
actually measures?*  `DriftMonitor` accumulates, per (setting key, op
type) cell, a Welford running mean/variance of the **log-ratio
residual** ``log(observed / predicted)`` — symmetric in over/under
prediction, scale-free across op magnitudes, and exactly the quantity
the log-affine calibration maps of `repro_torch.transfer` correct.

The drift *score* of a cell with at least ``min_count`` observations
is ``|mean residual| / threshold``: 0 means the bank is unbiased,
``>= 1`` means the systematic bias exceeds the configured tolerance
and recalibration should trigger.  `Welford` itself is exact (same
mean/variance as a two-pass computation, to float rounding) and its
JSON form is bit-stable, so drift state replays deterministically.

Feeders:
  * `ServeEngine` — every measured decode step against its predicted
    step latency (the serving-time signal);
  * `ProfileSession` — via the ``on_measure`` hook + the
    `attach_session_drift` helper, every *fresh* op measurement against
    the currently-served bank's prediction for that op (the
    profiling-time signal).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Welford", "DriftMonitor", "attach_session_drift"]

_EPS = 1e-12


class Welford:
    """Online mean/variance (Welford); mergeable (Chan et al.)."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self, n: int = 0, mean: float = 0.0, m2: float = 0.0):
        self.n = int(n)
        self.mean = float(mean)
        self.m2 = float(m2)

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    def merge(self, other: "Welford") -> "Welford":
        if other.n == 0:
            return self
        if self.n == 0:
            self.n, self.mean, self.m2 = other.n, other.mean, other.m2
            return self
        n = self.n + other.n
        d = other.mean - self.mean
        self.mean += d * other.n / n
        self.m2 += other.m2 + d * d * self.n * other.n / n
        self.n = n
        return self

    def variance(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0

    def std(self) -> float:
        return math.sqrt(max(self.variance(), 0.0))

    def to_json(self) -> Dict[str, Any]:
        return {"n": self.n, "mean": self.mean, "m2": self.m2}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Welford":
        return cls(n=int(d["n"]), mean=float(d["mean"]), m2=float(d["m2"]))


class DriftMonitor:
    """Per-(setting key, op type) residual accumulators + drift score."""

    def __init__(self, *, threshold: float = 0.25, min_count: int = 8):
        if threshold <= 0:
            raise ValueError("threshold must be > 0")
        self.threshold = float(threshold)
        self.min_count = int(min_count)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str], Welford] = {}
        self.observations = 0

    def observe(self, setting_key: str, op_type: str,
                predicted_s: float, observed_s: float) -> float:
        """Record one residual; returns it (log observed/predicted)."""
        r = math.log(max(float(observed_s), _EPS)) \
            - math.log(max(float(predicted_s), _EPS))
        key = (str(setting_key), str(op_type))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = Welford()
            cell.add(r)
            self.observations += 1
        return r

    def cell(self, setting_key: str, op_type: str) -> Optional[Welford]:
        with self._lock:
            c = self._cells.get((setting_key, op_type))
            return Welford(c.n, c.mean, c.m2) if c is not None else None

    def score(self, setting_key: Optional[str] = None,
              op_type: Optional[str] = None) -> float:
        """Max ``|mean residual| / threshold`` over matching cells with
        enough observations (0.0 when nothing qualifies)."""
        best = 0.0
        with self._lock:
            for (sk, ot), c in self._cells.items():
                if setting_key is not None and sk != setting_key:
                    continue
                if op_type is not None and ot != op_type:
                    continue
                if c.n < self.min_count:
                    continue
                best = max(best, abs(c.mean) / self.threshold)
        return best

    def drifted(self) -> List[Tuple[str, str, float]]:
        """Cells whose score crossed 1.0, worst first — the
        recalibration loop's work list."""
        out = []
        with self._lock:
            for (sk, ot), c in self._cells.items():
                if c.n < self.min_count:
                    continue
                s = abs(c.mean) / self.threshold
                if s >= 1.0:
                    out.append((sk, ot, s))
        out.sort(key=lambda t: (-t[2], t[0], t[1]))
        return out

    def worst_cells(self, k: int = 5) -> List[Dict[str, Any]]:
        """Top-``k`` offending cells, worst first, regardless of whether
        they crossed 1.0 — the autopilot's targeting list and the
        `health` endpoint's "top offender" summary.  Each entry:
        ``{setting, op_type, n, mean, score}``."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (sk, ot), c in self._cells.items():
                if c.n < self.min_count:
                    continue
                out.append({"setting": sk, "op_type": ot, "n": c.n,
                            "mean": c.mean,
                            "score": abs(c.mean) / self.threshold})
        out.sort(key=lambda d: (-d["score"], d["setting"], d["op_type"]))
        return out[:max(int(k), 0)]

    def snapshot(self) -> Dict[str, Any]:
        """Bit-stable JSON view (cells keyed ``"<setting>|<op_type>"``)."""
        with self._lock:
            cells = {f"{sk}|{ot}": c.to_json()
                     for (sk, ot), c in sorted(self._cells.items())}
            obs = self.observations
        return {"threshold": self.threshold, "min_count": self.min_count,
                "observations": obs, "cells": cells,
                "score": self.score(),
                "drifted": [[sk, ot, s] for sk, ot, s in self.drifted()]}

    def reset(self, setting_key: Optional[str] = None) -> None:
        """Forget accumulated residuals (after a recalibration rollout)."""
        with self._lock:
            if setting_key is None:
                self._cells.clear()
                self.observations = 0
            else:
                for key in [k for k in self._cells if k[0] == setting_key]:
                    self.observations -= self._cells[key].n
                    del self._cells[key]


def attach_session_drift(session: Any, service: Any, monitor: DriftMonitor,
                         *, family: Optional[str] = None
                         ) -> Callable[..., None]:
    """Wire a `ProfileSession`'s fresh measurements into ``monitor``.

    Installs an ``on_measure`` hook that, for every op the session
    actually times (store hits don't re-observe), predicts the same op
    through the bank ``service`` currently serves and records the
    residual.  Ops the bank has no predictor for are skipped — no
    prediction, no residual.
    """
    import numpy as np
    from repro_torch.pipeline.store import setting_key as _skey

    def on_measure(setting: Any, op_type: str,
                   features: Tuple[Any, Any], observed_s: float) -> None:
        try:
            bank = service.hub.get(setting, family or service.predictor)
        except Exception:
            return
        model = getattr(bank, "predictors", {}).get(op_type) \
            if bank is not None else None
        if model is None:
            return
        _names, vals = features
        x = np.asarray([vals], dtype=np.float64)
        predicted = float(model.predict(x)[0])
        monitor.observe(_skey(setting), op_type, predicted, observed_s)

    session.on_measure = on_measure
    return on_measure
