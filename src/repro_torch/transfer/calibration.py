"""Per-op-type source→target latency maps + the calibrated predictor.

The transfer hypothesis (Lu et al., "One Proxy Device Is Enough"): op
latency on two devices is related by a *monotone*, per-op-type map —
mostly a constant speed ratio, bent by frequency scaling, cache-size
and parallelism differences.  We model it directly:

  **affine-in-log-latency** (default)
      log t_target = a + b · log t_source      (t = e^a · s^b)
      b = 1 recovers a pure speed ratio; b ≠ 1 captures size-dependent
      divergence (e.g. the target falls off a cache cliff earlier).

  **isotonic fallback**
      When the log-affine fit degenerates (non-positive slope — the
      sampled pairs are not even directionally affine), a pool-adjacent-
      violators fit in log space keeps the map monotone, which is the
      one property transfer must not lose (a faster op on the source
      must not predict slower than a slower op).

Maps serialize to JSON **bit-exactly** like every predictor family:
parameters are plain Python floats, `json` round-trips them exactly,
and `apply` is deterministic — so `LatencyMap.from_json(m.to_json())`
produces identical outputs.

`CalibratedPredictor` (registered family "calibrated") wraps a trained
source predictor with a map, so a transferred `PredictorBank` is a
first-class bank: it serializes, `warm()`s, and serves through
`LatencyService` unchanged.

Port notes (copy of ``repro.transfer.calibration``): the wrapper is
`device_bound`, so `load_predictor(d, device)` hands it the device its
base is rebuilt on (lasso and the MLP run on a torch device).  The
device does not enter the JSON, which stays the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.predictors.base import PREDICTORS, Predictor, load_predictor
from repro_torch.utils.device import DeviceLike

_EPS = 1e-12

AFFINE_LOG = "affine_log"
ISOTONIC_LOG = "isotonic_log"


@dataclass(frozen=True)
class LatencyMap:
    """One monotone source→target latency map (seconds → seconds)."""

    kind: str                      # AFFINE_LOG | ISOTONIC_LOG
    a: float = 0.0                 # affine intercept (log space)
    b: float = 1.0                 # affine slope (log space)
    knots_x: Tuple[float, ...] = ()   # isotonic: log source latencies
    knots_y: Tuple[float, ...] = ()   # isotonic: fitted log targets
    n_fit: int = 0                 # pairs the map was fit on

    def apply(self, y: np.ndarray) -> np.ndarray:
        """Map source-scale latencies to the target scale (clamped ≥ 0)."""
        s = np.log(np.maximum(np.asarray(y, dtype=np.float64), _EPS))
        if self.kind == AFFINE_LOG:
            t = self.a + self.b * s
        elif self.kind == ISOTONIC_LOG:
            t = np.interp(s, self.knots_x, self.knots_y)
        else:
            raise ValueError(f"unknown latency-map kind {self.kind!r}")
        return np.exp(t)

    def apply_scalar(self, y: float) -> float:
        return float(self.apply(np.asarray([y]))[0])

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "a": self.a, "b": self.b,
                "knots_x": list(self.knots_x), "knots_y": list(self.knots_y),
                "n_fit": self.n_fit}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "LatencyMap":
        return cls(kind=d["kind"], a=float(d["a"]), b=float(d["b"]),
                   knots_x=tuple(float(v) for v in d["knots_x"]),
                   knots_y=tuple(float(v) for v in d["knots_y"]),
                   n_fit=int(d.get("n_fit", 0)))


def identity_map() -> LatencyMap:
    return LatencyMap(AFFINE_LOG, a=0.0, b=1.0, n_fit=0)


def scale_map(ratio: float, n_fit: int = 0) -> LatencyMap:
    """Pure speed-ratio map t = ratio · s (the descriptor-prior shape)."""
    return LatencyMap(AFFINE_LOG, a=float(np.log(max(ratio, _EPS))), b=1.0,
                      n_fit=n_fit)


def _pav(y: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: least-squares nondecreasing fit of y."""
    n = len(y)
    level = y.astype(np.float64).copy()
    weight = np.ones(n)
    # Active blocks as (value, weight) merged right-to-left on violation.
    vals: List[float] = []
    wts: List[float] = []
    for i in range(n):
        v, w = level[i], weight[i]
        while vals and vals[-1] > v:
            pv, pw = vals.pop(), wts.pop()
            v = (pv * pw + v * w) / (pw + w)
            w = pw + w
        vals.append(v)
        wts.append(w)
    out = np.empty(n)
    pos = 0
    for v, w in zip(vals, wts):
        out[pos:pos + int(w)] = v
        pos += int(w)
    return out


def fit_latency_map(source_s: Sequence[float],
                    target_s: Sequence[float],
                    *, slope_shrink: float = 4.0) -> LatencyMap:
    """Fit one map from paired (source, target) latency measurements.

    Affine-in-log by least squares, with the slope shrunk toward 1 as
    b ← 1 + (b_ls − 1)·n/(n + slope_shrink): on 2–3 noisy pairs a free
    slope overfits badly (a wrong exponent *extrapolates* wrong), so
    small samples stay close to a pure speed ratio and the data earns
    the slope as pairs accumulate.  A single pair pins the ratio
    (b = 1); a degenerate fit (non-positive slope) falls back to an
    isotonic fit in log space when ≥ 3 pairs support it, else to the
    mean speed ratio.
    """
    src = np.asarray(source_s, dtype=np.float64)
    tgt = np.asarray(target_s, dtype=np.float64)
    if src.shape != tgt.shape or src.ndim != 1:
        raise ValueError("source/target pairs must be equal-length 1-D")
    n = len(src)
    if n == 0:
        raise ValueError("cannot fit a latency map on zero pairs")
    s = np.log(np.maximum(src, _EPS))
    t = np.log(np.maximum(tgt, _EPS))
    if n == 1 or float(np.ptp(s)) < 1e-9:
        return LatencyMap(AFFINE_LOG, a=float(np.mean(t - s)), b=1.0, n_fit=n)
    a_mat = np.stack([np.ones_like(s), s], axis=1)
    (a, b), *_ = np.linalg.lstsq(a_mat, t, rcond=None)
    if b > 0:
        b = 1.0 + (float(b) - 1.0) * (n / (n + max(slope_shrink, 0.0)))
        a = float(np.mean(t - b * s))     # re-center for the shrunk slope
        return LatencyMap(AFFINE_LOG, a=a, b=float(b), n_fit=n)
    if n >= 3:
        order = np.argsort(s, kind="stable")
        xs, ys = s[order], t[order]
        # Merge duplicate source points (mean target) so knots are
        # strictly usable by interp, then enforce monotonicity via PAV.
        ux, inv = np.unique(xs, return_inverse=True)
        uy = np.zeros(len(ux))
        cnt = np.zeros(len(ux))
        np.add.at(uy, inv, ys)
        np.add.at(cnt, inv, 1.0)
        uy = uy / cnt
        return LatencyMap(ISOTONIC_LOG,
                          knots_x=tuple(float(v) for v in ux),
                          knots_y=tuple(float(v) for v in _pav(uy)),
                          n_fit=n)
    return LatencyMap(AFFINE_LOG, a=float(np.mean(t - s)), b=1.0, n_fit=n)


# ---------------------------------------------------------------------------
# Calibrated predictor — a bank-compatible wrapper
# ---------------------------------------------------------------------------

@PREDICTORS.register("calibrated")
class CalibratedPredictor(Predictor):
    """A trained source predictor composed with a `LatencyMap`.

    Not fit directly — built by `wrap` (or deserialization) around an
    already-fitted base.  Prediction is base-predict → map; the base's
    compiled fast path (flattened ensembles) is reused untouched.
    """

    name = "calibrated"
    # Takes the device its base is loaded on (see the module's port notes).
    device_bound = True

    def __init__(self, device: DeviceLike = "cuda", **hparams: Any):
        super().__init__(**hparams)
        self.device = device
        self.base: Optional[Predictor] = None
        self.map: Optional[LatencyMap] = None

    @classmethod
    def wrap(cls, base: Predictor, latency_map: LatencyMap
             ) -> "CalibratedPredictor":
        if isinstance(base, CalibratedPredictor):
            raise TypeError("refusing to stack calibrations; wrap the "
                            "original source predictor instead")
        m = cls(device=getattr(base, "device", "cuda"))
        m.base = base
        m.map = latency_map
        m.scaler = base.scaler
        return m

    # -- prediction ----------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.maximum(self.map.apply(self.base.predict(x)), 0.0)

    def predict_oracle(self, x: np.ndarray) -> np.ndarray:
        return np.maximum(self.map.apply(self.base.predict_oracle(x)), 0.0)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "Predictor":
        raise RuntimeError("CalibratedPredictor is not fit directly; fit the "
                           "base predictor and use CalibratedPredictor.wrap")

    def finalize(self) -> "Predictor":
        self.base.finalize()
        return self

    def tree_model(self):
        return None if self.base is None else self.base.tree_model()

    # -- serialization --------------------------------------------------------
    def _config_json(self) -> Dict[str, Any]:
        return {}

    def to_json(self) -> Dict[str, Any]:
        if self.base is None or self.map is None:
            raise RuntimeError("cannot serialize an empty CalibratedPredictor")
        return {
            "name": self.name,
            "config": self._config_json(),
            # load_predictor restores this into self.scaler; the wrapper
            # mirrors the base's scaler (prediction goes through base).
            "scaler": self.base.scaler.to_json(),
            "state": self._state_to_json(),
        }

    def _state_to_json(self) -> Dict[str, Any]:
        return {"base": self.base.to_json(), "map": self.map.to_json()}

    def _state_from_json(self, d: Dict[str, Any]) -> None:
        self.base = load_predictor(d["base"], self.device)
        self.map = LatencyMap.from_json(d["map"])
