"""Random Forest regressor (paper §4.2): bagged CART trees.

Hyperparameters mirror the paper: number of trees (1–10) and
min_samples_split (2–50), tuned with 5-fold CV via `fit_with_cv`.
Sample weights 1/y² align splitting with the relative-error objective.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.core.predictors.base import PREDICTORS, Predictor, grid_search, relative_weights
from repro_torch.core.predictors.flat import FlattenedTreeModel
from repro_torch.core.predictors.trees import RegressionTree

DEFAULT_GRID = tuple(
    {"n_trees": nt, "min_samples_split": ms}
    for nt in (4, 10)
    for ms in (2, 10, 50)
)


@PREDICTORS.register("rf")
class RandomForestPredictor(FlattenedTreeModel, Predictor):
    name = "rf"

    def __init__(self, n_trees: int = 10, min_samples_split: int = 2,
                 max_depth: int = 14, max_features: Optional[float] = 0.8,
                 seed: int = 0, relative: bool = True):
        super().__init__(n_trees=n_trees, min_samples_split=min_samples_split)
        self.n_trees = int(n_trees)
        self.min_samples_split = int(min_samples_split)
        self.max_depth = int(max_depth)
        self.max_features = max_features
        self.seed = seed
        self.relative = relative
        self.trees: list[RegressionTree] = []
        self._init_flat()

    def _fit(self, xs: np.ndarray, y: np.ndarray) -> None:
        rng = np.random.default_rng(self.seed)
        n = len(y)
        w = relative_weights(y) if self.relative else np.ones(n)
        self.trees = []
        for t in range(self.n_trees):
            idx = rng.integers(0, n, size=n)  # bootstrap
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_split=self.min_samples_split,
                max_features=self.max_features,
                seed=self.seed + 1000 * t,
            )
            tree.fit(xs[idx], y[idx], sample_weight=w[idx])
            self.trees.append(tree)
        self._invalidate_flat()

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        vals = self.flat().predict_trees(xs, backend=self.inference_backend)
        # (trees, rows) contiguous before the mean: same reduction layout
        # as the oracle's np.stack(...).mean(axis=0), so results stay
        # bit-identical (numpy's pairwise summation is layout-sensitive).
        return np.ascontiguousarray(vals.T).mean(axis=0)

    def _predict_oracle(self, xs: np.ndarray) -> np.ndarray:
        preds = np.stack([t.predict_oracle(xs) for t in self.trees])
        return preds.mean(axis=0)

    def _device_reduction(self):
        return ("mean", 1.0, 0.0)

    # -- serialization --------------------------------------------------------
    def _config_json(self):
        return {"n_trees": self.n_trees,
                "min_samples_split": self.min_samples_split,
                "max_depth": self.max_depth, "max_features": self.max_features,
                "seed": self.seed, "relative": self.relative}

    def _state_to_json(self):
        return {"trees": [t.to_json() for t in self.trees]}

    def _state_from_json(self, d):
        self.trees = [RegressionTree.from_json(t) for t in d["trees"]]
        self._invalidate_flat()


def fit_rf_with_cv(x: np.ndarray, y: np.ndarray,
                   grid: Sequence[dict] = DEFAULT_GRID,
                   seed: int = 0) -> RandomForestPredictor:
    hp, _ = grid_search(lambda **h: RandomForestPredictor(seed=seed, **h), grid, x, y)
    model = RandomForestPredictor(seed=seed, **hp)
    model.fit(x, y)
    return model
