"""Weighted CART regression trees (numpy) — substrate for RF and GBDT.

Exact greedy splitting on weighted squared error.  With sample weights
1/y², squared error becomes squared *percentage* error, matching the
paper's objective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.predictors.flat import FlatEnsemble


@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


class RegressionTree:
    def __init__(self, max_depth: int = 12, min_samples_split: int = 2,
                 min_samples_leaf: int = 1,
                 max_features: Optional[float] = None, seed: int = 0):
        self.max_depth = max_depth
        self.min_samples_split = max(2, min_samples_split)
        self.min_samples_leaf = max(1, min_samples_leaf)
        self.max_features = max_features
        self.seed = seed
        self.nodes: List[_Node] = []
        self._flat: Optional[FlatEnsemble] = None   # compiled form (lazy)

    # -- fitting -------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None) -> "RegressionTree":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        w = np.ones(len(y)) if sample_weight is None else np.asarray(sample_weight, dtype=np.float64)
        self.nodes = []
        self._flat = None
        self._rng = np.random.default_rng(self.seed)
        self._build(x, y, w, np.arange(len(y)), depth=0)
        return self

    def _leaf(self, y: np.ndarray, w: np.ndarray, idx: np.ndarray) -> int:
        wi = w[idx]
        val = float(np.average(y[idx], weights=wi)) if wi.sum() > 0 else float(np.mean(y[idx]))
        self.nodes.append(_Node(value=val, is_leaf=True))
        return len(self.nodes) - 1

    def _build(self, x: np.ndarray, y: np.ndarray, w: np.ndarray,
               idx: np.ndarray, depth: int) -> int:
        n = len(idx)
        if (depth >= self.max_depth or n < self.min_samples_split
                or np.all(y[idx] == y[idx][0])):
            return self._leaf(y, w, idx)
        best = self._best_split(x, y, w, idx)
        if best is None:
            return self._leaf(y, w, idx)
        feat, thr = best
        mask = x[idx, feat] <= thr
        left_idx, right_idx = idx[mask], idx[~mask]
        if len(left_idx) < self.min_samples_leaf or len(right_idx) < self.min_samples_leaf:
            return self._leaf(y, w, idx)
        node_id = len(self.nodes)
        self.nodes.append(_Node(feature=feat, threshold=thr, is_leaf=False))
        left = self._build(x, y, w, left_idx, depth + 1)
        right = self._build(x, y, w, right_idx, depth + 1)
        self.nodes[node_id].left = left
        self.nodes[node_id].right = right
        return node_id

    def _best_split(self, x: np.ndarray, y: np.ndarray, w: np.ndarray,
                    idx: np.ndarray) -> Optional[Tuple[int, float]]:
        d = x.shape[1]
        feats = np.arange(d)
        if self.max_features is not None and self.max_features < 1.0:
            k = max(1, int(round(self.max_features * d)))
            feats = self._rng.choice(d, size=k, replace=False)
        xs, ys, ws = x[idx], y[idx], w[idx]
        best_gain, best = -1e-18, None
        wy, wyy = ws * ys, ws * ys * ys
        total_w, total_wy, total_wyy = ws.sum(), wy.sum(), wyy.sum()
        parent_sse = total_wyy - total_wy ** 2 / max(total_w, 1e-300)
        for f in feats:
            order = np.argsort(xs[:, f], kind="stable")
            xv = xs[order, f]
            cw = np.cumsum(ws[order])
            cwy = np.cumsum(wy[order])
            cwyy = np.cumsum(wyy[order])
            # Valid split positions: value changes between i and i+1.
            valid = np.nonzero(xv[:-1] < xv[1:])[0]
            if len(valid) == 0:
                continue
            lw, lwy, lwyy = cw[valid], cwy[valid], cwyy[valid]
            rw, rwy, rwyy = total_w - lw, total_wy - lwy, total_wyy - lwyy
            sse = (lwyy - lwy ** 2 / np.maximum(lw, 1e-300)) + \
                  (rwyy - rwy ** 2 / np.maximum(rw, 1e-300))
            gains = parent_sse - sse
            i = int(np.argmax(gains))
            if gains[i] > best_gain:
                best_gain = float(gains[i])
                thr = 0.5 * (xv[valid[i]] + xv[valid[i] + 1])
                best = (int(f), float(thr))
        if best is None or best_gain <= 1e-18:
            return None
        return best

    # -- serialization --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "max_depth": self.max_depth,
            "min_samples_split": self.min_samples_split,
            "min_samples_leaf": self.min_samples_leaf,
            "max_features": self.max_features,
            "seed": self.seed,
            "nodes": [[n.feature, n.threshold, n.left, n.right, n.value, n.is_leaf]
                      for n in self.nodes],
        }

    @classmethod
    def from_json(cls, d: dict) -> "RegressionTree":
        t = cls(max_depth=d["max_depth"], min_samples_split=d["min_samples_split"],
                min_samples_leaf=d["min_samples_leaf"],
                max_features=d["max_features"], seed=d["seed"])
        t.nodes = [_Node(feature=int(f), threshold=float(thr), left=int(l),
                         right=int(r), value=float(v), is_leaf=bool(leaf))
                   for f, thr, l, r, v, leaf in d["nodes"]]
        return t

    # -- prediction -----------------------------------------------------------
    def flat(self) -> FlatEnsemble:
        """Struct-of-arrays form of this tree (built lazily, cached)."""
        if self._flat is None or self._flat.n_nodes != len(self.nodes):
            self._flat = FlatEnsemble.from_trees([self])
        return self._flat

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized batched traversal (bit-identical to the node-walk)."""
        x = np.asarray(x, dtype=np.float64)
        return self.flat().predict_trees(x)[:, 0]

    def predict_oracle(self, x: np.ndarray) -> np.ndarray:
        """Reference per-row node-walk — kept as the parity-test oracle."""
        x = np.asarray(x, dtype=np.float64)
        out = np.empty(len(x))
        for i, row in enumerate(x):
            nid = 0
            node = self.nodes[nid]
            while not node.is_leaf:
                nid = node.left if row[node.feature] <= node.threshold else node.right
                node = self.nodes[nid]
            out[i] = node.value
        return out
