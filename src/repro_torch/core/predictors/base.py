"""Predictor API: standardization + relative-error objective (paper §4.2).

Features are standardized with *training-set* mean/std:
    x̂_ij = (x_ij − μ_j) / σ_j
and models minimize mean squared *percentage* error
    (1/N) Σ |(f(x̂_i) − y_i) / y_i|²
with MAPE as the reported metric.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.utils.device import DeviceLike
from repro_torch.utils.registry import Registry

PREDICTORS = Registry("predictor")


@dataclass
class Standardizer:
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "Standardizer":
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0)
        self.std = np.where(self.std < 1e-12, 1.0, self.std)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.mean is None:
            raise RuntimeError("Standardizer not fitted")
        return (x - self.mean) / self.std

    def to_json(self) -> Dict[str, Any]:
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Standardizer":
        s = cls()
        s.mean = np.asarray(d["mean"], dtype=np.float64)
        s.std = np.asarray(d["std"], dtype=np.float64)
        return s


class Predictor:
    """Base: fit(X, y) on raw features; predict(X) returns latency."""

    name = "base"
    # True for families that fit (and, for the MLP, predict) on a torch
    # device and so take a ``device`` argument; the tree families get
    # theirs from the serving layer at predict time instead.
    device_bound = False

    def __init__(self, **hparams: Any):
        self.hparams = dict(hparams)
        self.scaler = Standardizer()

    # -- to be implemented by subclasses on standardized features -----------
    def _fit(self, xs: np.ndarray, y: np.ndarray) -> None:
        raise NotImplementedError

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- public API ----------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "Predictor":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"X must be 2-D, got {x.shape}")
        if len(x) != len(y):
            raise ValueError("X/y length mismatch")
        self.scaler.fit(x)
        self._fit(self.scaler.transform(x), y)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return np.maximum(self._predict(self.scaler.transform(x)), 0.0)

    def _predict_oracle(self, xs: np.ndarray) -> np.ndarray:
        # Tree families override with the per-row node-walk reference
        # implementation; everything else has a single code path.
        return self._predict(xs)

    def predict_oracle(self, x: np.ndarray) -> np.ndarray:
        """`predict` through the slow reference path (parity tests/bench)."""
        x = np.asarray(x, dtype=np.float64)
        return np.maximum(self._predict_oracle(self.scaler.transform(x)), 0.0)

    def finalize(self) -> "Predictor":
        """Build any compiled inference state eagerly (no-op by default).

        Called after training / deserialization (`PredictorBank.warm`) so
        the first serving query doesn't pay one-time compilation cost.
        """
        return self

    def tree_model(self) -> Optional["Predictor"]:
        """The fitted flattened-tree model serving this predictor, or
        None for non-tree families.  Wrappers (calibrated transfer
        predictors) delegate to the model they wrap, so serving layers
        can steer the traversal backend without knowing wrapper
        internals.
        """
        return self if getattr(self, "trees", None) else None

    def mape(self, x: np.ndarray, y: np.ndarray) -> float:
        y = np.asarray(y, dtype=np.float64)
        pred = self.predict(x)
        # Clamp |y|: np.where(y == 0, ...) left negative-or-tiny labels
        # dividing unprotected (|y| < 1e-12 explodes the metric).
        return float(np.mean(np.abs((pred - y) / np.maximum(np.abs(y), 1e-12))))

    # -- serialization --------------------------------------------------------
    # Subclasses implement `_config_json` (constructor kwargs sufficient to
    # rebuild an unfitted instance) and `_state_to_json`/`_state_from_json`
    # (the fitted state).  `load_predictor` gives the full round-trip.
    def _config_json(self) -> Dict[str, Any]:
        raise NotImplementedError(f"{self.name} is not serializable")

    def _state_to_json(self) -> Dict[str, Any]:
        raise NotImplementedError(f"{self.name} is not serializable")

    def _state_from_json(self, d: Dict[str, Any]) -> None:
        raise NotImplementedError(f"{self.name} is not serializable")

    def to_json(self) -> Dict[str, Any]:
        if self.scaler.mean is None:
            raise RuntimeError(f"cannot serialize unfitted {self.name} predictor")
        return {
            "name": self.name,
            "config": self._config_json(),
            "scaler": self.scaler.to_json(),
            "state": self._state_to_json(),
        }


def build_predictor(name: str, device: DeviceLike = "cuda",
                    **config: Any) -> "Predictor":
    """An unfitted predictor of family ``name``; ``device`` goes to the
    families that run on a torch device (`Predictor.device_bound`)."""
    cls = PREDICTORS.get(name)
    if cls.device_bound:
        config["device"] = device
    return cls(**config)


def load_predictor(d: Dict[str, Any], device: DeviceLike = "cuda") -> "Predictor":
    """Rebuild a fitted predictor from `Predictor.to_json` output
    (``device``: where a device-bound family fits and predicts)."""
    import repro_torch.core.predictors  # noqa: F401 — populate the registry

    if d["name"] not in PREDICTORS:
        # Higher layers register extra families (the transfer layer's
        # "calibrated" wrapper); pull them in lazily so a bank saved by
        # that layer loads in a process that never imported it.  The
        # module is part of this package: a failed import raises.
        import repro_torch.transfer.calibration  # noqa: F401
    model = build_predictor(d["name"], device, **d["config"])
    model.scaler = Standardizer.from_json(d["scaler"])
    model._state_from_json(d["state"])
    return model


def relative_weights(y: np.ndarray) -> np.ndarray:
    """Sample weights 1/y² turning squared error into squared % error."""
    y = np.asarray(y, dtype=np.float64)
    return 1.0 / np.maximum(y, 1e-12) ** 2


def kfold_indices(n: int, k: int, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    out = []
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i]) if k > 1 else val
        out.append((train, val))
    return out


def cross_val_mape(make_model, x: np.ndarray, y: np.ndarray,
                   k: int = 5, seed: int = 0) -> float:
    """k-fold CV MAPE for hyperparameter selection (paper uses 5-fold)."""
    n = len(y)
    k = min(k, max(2, n // 2)) if n >= 4 else 2
    scores = []
    for train_idx, val_idx in kfold_indices(n, k, seed):
        if len(train_idx) == 0 or len(val_idx) == 0:
            continue
        m = make_model()
        m.fit(x[train_idx], y[train_idx])
        scores.append(m.mape(x[val_idx], y[val_idx]))
    return float(np.mean(scores)) if scores else float("inf")


def grid_search(make_model, grid: Sequence[Dict[str, Any]],
                x: np.ndarray, y: np.ndarray, *, k: int = 5,
                seed: int = 0) -> Tuple[Dict[str, Any], float]:
    """Pick hyperparameters minimizing CV MAPE; refit is the caller's job."""
    best, best_score = None, float("inf")
    for hp in grid:
        score = cross_val_mape(lambda hp=hp: make_model(**hp), x, y, k=k, seed=seed)
        if score < best_score:
            best, best_score = hp, score
    return best or {}, best_score
