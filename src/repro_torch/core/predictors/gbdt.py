"""Gradient-Boosted Decision Trees (paper §4.2).

Weighted least-squares boosting: each stage fits the residual (y − F)
with sample weights 1/y², which is exactly gradient boosting on the
squared-percentage-error loss (up to the constant 2/y² absorbed into
the weights).  Hyperparameters mirror the paper: number of stages
(1–200) and min_samples_split (2–7), CV-selected.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.predictors.base import PREDICTORS, Predictor, grid_search, relative_weights
from repro_torch.core.predictors.flat import FlattenedTreeModel
from repro_torch.core.predictors.trees import RegressionTree

DEFAULT_GRID = tuple(
    {"n_stages": ns, "min_samples_split": ms}
    for ns in (50, 200)
    for ms in (2, 7)
)


@PREDICTORS.register("gbdt")
class GBDTPredictor(FlattenedTreeModel, Predictor):
    name = "gbdt"

    def __init__(self, n_stages: int = 200, learning_rate: float = 0.1,
                 max_depth: int = 4, min_samples_split: int = 2,
                 seed: int = 0, relative: bool = True,
                 subsample: float = 1.0):
        super().__init__(n_stages=n_stages, learning_rate=learning_rate)
        self.n_stages = int(n_stages)
        self.learning_rate = float(learning_rate)
        self.max_depth = int(max_depth)
        self.min_samples_split = int(min_samples_split)
        self.seed = seed
        self.relative = relative
        self.subsample = subsample
        self.trees: list[RegressionTree] = []
        self.f0: float = 0.0
        self._init_flat()

    def _fit(self, xs: np.ndarray, y: np.ndarray) -> None:
        n = len(y)
        w = relative_weights(y) if self.relative else np.ones(n)
        # F0: weighted mean (minimizer of the weighted squared loss).
        self.f0 = float(np.average(y, weights=w))
        f = np.full(n, self.f0)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for t in range(self.n_stages):
            resid = y - f
            if self.subsample < 1.0:
                idx = rng.choice(n, size=max(2, int(self.subsample * n)), replace=False)
            else:
                idx = np.arange(n)
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_split=self.min_samples_split,
                seed=self.seed + 7919 * t,
            )
            tree.fit(xs[idx], resid[idx], sample_weight=w[idx])
            f = f + self.learning_rate * tree.predict(xs)
            self.trees.append(tree)
        self._invalidate_flat()

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        out = np.full(len(xs), self.f0)
        if not self.trees:
            return out
        vals = self.flat().predict_trees(xs, backend=self.inference_backend)
        # Accumulate stage by stage in the oracle's order (out += lr·pred
        # per stage) so results stay bit-identical; the expensive part —
        # tree traversal — is already batched above.
        for j in range(vals.shape[1]):
            out += self.learning_rate * vals[:, j]
        return out

    def _predict_oracle(self, xs: np.ndarray) -> np.ndarray:
        out = np.full(len(xs), self.f0)
        for tree in self.trees:
            out += self.learning_rate * tree.predict_oracle(xs)
        return out

    def _device_reduction(self):
        # pred = f0 + lr·Σ_stage leaf  →  one fused sum on device.
        return ("sum", self.learning_rate, self.f0)

    # -- serialization --------------------------------------------------------
    def _config_json(self):
        return {"n_stages": self.n_stages, "learning_rate": self.learning_rate,
                "max_depth": self.max_depth,
                "min_samples_split": self.min_samples_split, "seed": self.seed,
                "relative": self.relative, "subsample": self.subsample}

    def _state_to_json(self):
        return {"f0": self.f0, "trees": [t.to_json() for t in self.trees]}

    def _state_from_json(self, d):
        self.f0 = float(d["f0"])
        self.trees = [RegressionTree.from_json(t) for t in d["trees"]]
        self._invalidate_flat()


def fit_gbdt_with_cv(x: np.ndarray, y: np.ndarray,
                     grid: Sequence[dict] = DEFAULT_GRID,
                     seed: int = 0) -> GBDTPredictor:
    hp, _ = grid_search(lambda **h: GBDTPredictor(seed=seed, **h), grid, x, y)
    model = GBDTPredictor(seed=seed, **hp)
    model.fit(x, y)
    return model
