"""Non-negative Lasso with relative-error loss (paper Eq. (1)), on torch.

    w* = argmin_w (1/N) Σ |(wᵀx̂_i − y_i)/y_i|² + α‖w‖₁   s.t.  w ≥ 0

Solved by proximal (projected ISTA) gradient descent: for the nonneg
orthant the prox of α‖·‖₁ is a shifted soft-threshold,
    w ← max(0, w − η(∇L + 0)) with w ← max(0, w − ηα) absorbed into it.
α is grid-searched over [1e-5, 1e2] (paper §4.2).

The paper's Eq. (1) has no intercept; with standardized (zero-mean)
features a nonneg combination struggles to hit positive targets, so we
support an optional intercept (default ON, noted in DESIGN.md §8).  The
intercept is unpenalized and unconstrained.

Port notes (twin of the reference's ``repro.core.predictors.lasso``):
the solver `_ista_torch` runs the reference's jitted float32 iteration
(16 power iterations for the Lipschitz step, then ``iters`` projected
ISTA steps, in the same order of operations) as torch ops on the
predictor's ``device`` — the card unless ``device="cpu"``.  Prediction
stays numpy on the host, as in the reference, so a bank saved by either
package predicts bit-identically in the other; the JSON is the
reference's field for field (``device`` is not part of it).
`_ista_numpy` is the reference's float64 oracle, kept for the tests.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.predictors.base import PREDICTORS, Predictor
from repro_torch.utils.device import DeviceLike, resolve_device

DEFAULT_ALPHA_GRID = tuple(float(a) for a in np.logspace(-5, 2, 8))


def _ista_numpy(xs: np.ndarray, y: np.ndarray, alpha: float, iters: int,
                fit_intercept: bool) -> np.ndarray:
    n, d = xs.shape
    w_inv = 1.0 / np.maximum(y, 1e-12)
    a = xs * w_inv[:, None]          # rows scaled so residual is relative
    if fit_intercept:
        a = np.concatenate([a, w_inv[:, None]], axis=1)
        d += 1
    target = np.ones(n)
    lip = np.linalg.norm(a, ord=2) ** 2 * 2.0 / n + 1e-12
    eta = 1.0 / lip
    w = np.zeros(d)
    for _ in range(iters):
        grad = 2.0 / n * a.T @ (a @ w - target)
        w = w - eta * grad
        w_feat = np.maximum(0.0, w[: d - 1] - eta * alpha) if fit_intercept \
            else np.maximum(0.0, w - eta * alpha)
        if fit_intercept:
            w = np.concatenate([w_feat, w[-1:]])
        else:
            w = w_feat
    return w


@torch.no_grad()
def _ista_torch(a: torch.Tensor, alpha: float, iters: int,
                fit_intercept: bool) -> torch.Tensor:
    """Projected ISTA on the row-scaled design ``a`` (float32, on its
    device); the iterate stays on that device."""
    n, d = a.shape
    target = torch.ones(n, dtype=a.dtype, device=a.device)
    # Lipschitz bound via power iteration on AᵀA (cheap, robust).
    v = torch.ones(d, dtype=a.dtype, device=a.device) / math.sqrt(d)
    for _ in range(16):
        v = a.T @ (a @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    lip = torch.linalg.vector_norm(a @ v) ** 2 * 2.0 / n + 1e-9
    eta = 1.0 / lip
    step = eta * alpha
    # (2/n)·Aᵀ scales the matrix before the product, as the reference's
    # ``2.0 / n * a.T @ r`` does (``*`` and ``@`` bind left to right).
    at2 = 2.0 / n * a.T
    w = torch.zeros(d, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        grad = at2 @ (a @ w - target)
        w = w - eta * grad
        if fit_intercept:
            w = torch.cat([torch.clamp_min(w[:-1] - step, 0.0), w[-1:]])
        else:
            w = torch.clamp_min(w - step, 0.0)
    return w


@PREDICTORS.register("lasso")
class LassoPredictor(Predictor):
    """Paper's linear approach: interpretable, tiny-data-friendly."""

    name = "lasso"
    device_bound = True

    def __init__(self, alpha: Optional[float] = None,
                 alpha_grid: Any = DEFAULT_ALPHA_GRID,
                 iters: int = 800, fit_intercept: bool = True,
                 seed: int = 0, device: DeviceLike = "cuda"):
        super().__init__(alpha=alpha, iters=iters, fit_intercept=fit_intercept)
        self.alpha = alpha
        self.alpha_grid = tuple(alpha_grid)
        self.iters = int(iters)
        self.fit_intercept = bool(fit_intercept)
        self.seed = seed
        self.device = resolve_device(device)
        self.w: Optional[np.ndarray] = None
        # Where the last solve's iterate lived (not serialized).
        self.fit_device: Optional[torch.device] = None

    def _solve(self, xs: np.ndarray, y: np.ndarray, alpha: float) -> np.ndarray:
        w_inv = 1.0 / np.maximum(y, 1e-12)
        a = xs * w_inv[:, None]
        if self.fit_intercept:
            a = np.concatenate([a, w_inv[:, None]], axis=1)
        w = _ista_torch(torch.as_tensor(a, dtype=torch.float32, device=self.device),
                        float(alpha), self.iters, self.fit_intercept)
        self.fit_device = w.device
        return w.cpu().numpy()

    def _fit(self, xs: np.ndarray, y: np.ndarray) -> None:
        if self.alpha is not None:
            self.w = self._solve(xs, y, self.alpha)
            return
        # Grid-search α on a holdout split (cheaper than full CV; the
        # objective is convex so scores are stable).
        n = len(y)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_val = max(1, n // 5)
        val, tr = perm[:n_val], perm[n_val:]
        if len(tr) == 0:
            tr = val
        best_alpha, best = self.alpha_grid[0], float("inf")
        for alpha in self.alpha_grid:
            w = self._solve(xs[tr], y[tr], alpha)
            pred = self._apply(xs[val], w)
            m = np.mean(np.abs((pred - y[val]) / np.maximum(y[val], 1e-12)))
            if m < best:
                best, best_alpha = m, alpha
        self.alpha = best_alpha
        self.w = self._solve(xs, y, best_alpha)

    def _apply(self, xs: np.ndarray, w: np.ndarray) -> np.ndarray:
        if self.fit_intercept:
            return xs @ w[:-1] + w[-1]
        return xs @ w

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        if self.w is None:
            raise RuntimeError("not fitted")
        return self._apply(xs, self.w)

    # -- serialization --------------------------------------------------------
    def _config_json(self):
        return {"alpha": self.alpha, "alpha_grid": list(self.alpha_grid),
                "iters": self.iters, "fit_intercept": self.fit_intercept,
                "seed": self.seed}

    def _state_to_json(self):
        return {"w": None if self.w is None else self.w.tolist()}

    def _state_from_json(self, d):
        self.w = None if d["w"] is None else np.asarray(d["w"], dtype=np.float64)

    @property
    def feature_weights(self) -> np.ndarray:
        """Magnitudes used for the paper's §5.5.2 feature-importance study."""
        if self.w is None:
            raise RuntimeError("not fitted")
        return self.w[:-1] if self.fit_intercept else self.w
