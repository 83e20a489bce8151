"""End-to-end latency composition (paper §4.2).

    T_e2e = T_overhead + Σ_{c ∈ C} f*_c(x̂_c)

where f*_c is the per-op-type predictor and T_overhead is the average
gap between measured end-to-end latency and the sum of measured per-op
latencies over the *training* set (paper Fig. 10: the gap fluctuates
around a constant per device).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.features import featurize, graph_features
from repro_torch.core.fusion import fuse_graph
from repro_torch.core.ir import OpGraph
from repro_torch.core.predictors.base import Predictor
from repro_torch.utils.device import DeviceLike


@dataclass
class PredictorBank:
    """One trained predictor per op type (per device setting).

    Overhead model: ``constant`` is the paper's T_overhead; ``per_kernel``
    (beyond-paper) models the gap as a + b·num_kernels, which fits
    async-dispatch runtimes (XLA:CPU) where per-op dispatch overlaps
    compute and the gap grows with op count.
    """

    predictors: Dict[str, Predictor] = field(default_factory=dict)
    overhead: float = 0.0
    overhead_per_kernel: float = 0.0
    op_sum_scale: float = 1.0      # 'affine' calibration: e2e ≈ α·Σops + a + b·K
    setting: str = ""

    def predict_op(self, graph: OpGraph, node) -> float:
        pred = self.predictors.get(node.op_type)
        if pred is None:
            # Unseen op type: fall back to zero (paper's predictors cover
            # every type in the space; this keeps composition total).
            return 0.0
        _, x = featurize(graph, node)
        return float(np.maximum(pred.predict(x[None, :])[0], 0.0))

    def predict_graph(self, graph: OpGraph, *, fused: bool = False) -> float:
        """Predict end-to-end latency of one architecture."""
        g = graph
        if fused:
            _, g = fuse_graph(graph)
        total = self.overhead + self.overhead_per_kernel * len(g.nodes)
        for _, p in self._predict_node_values(g):
            total += self.op_sum_scale * p
        return total

    def predict_ops(self, graph: OpGraph, *, fused: bool = False) -> List[Tuple[str, float]]:
        g = graph
        if fused:
            _, g = fuse_graph(graph)
        return self._predict_node_values(g)

    def _predict_node_values(self, g: OpGraph) -> List[Tuple[str, float]]:
        """(op_type, predicted seconds) per node — one predictor call per
        op type over the graph's cached feature matrices (fast path)."""
        gf = graph_features(g)
        vals = np.zeros(len(g.nodes))
        for op_type, x in gf.matrix.items():
            model = self.predictors.get(op_type)
            if model is None:
                continue      # unseen type → 0, same fallback as predict_op
            vals[gf.index[op_type]] = model.predict(x)
        return [(n.op_type, float(v)) for n, v in zip(g.nodes, vals)]

    def warm(self) -> "PredictorBank":
        """Eagerly build compiled inference state (flattened ensembles)
        so the first serving query doesn't pay one-time setup cost."""
        for p in self.predictors.values():
            p.finalize()
        return self

    # -- serialization --------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "setting": self.setting,
            "overhead": self.overhead,
            "overhead_per_kernel": self.overhead_per_kernel,
            "op_sum_scale": self.op_sum_scale,
            "predictors": {t: p.to_json() for t, p in sorted(self.predictors.items())},
        }

    @classmethod
    def from_json(cls, d: Dict, device: DeviceLike = "cuda") -> "PredictorBank":
        """Inverse of `to_json`; device-bound predictors (lasso, MLP)
        are rebuilt on ``device``."""
        from repro_torch.core.predictors.base import load_predictor

        bank = cls(setting=d["setting"], overhead=float(d["overhead"]),
                   overhead_per_kernel=float(d["overhead_per_kernel"]),
                   op_sum_scale=float(d["op_sum_scale"]))
        bank.predictors = {t: load_predictor(p, device)
                           for t, p in d["predictors"].items()}
        return bank.warm()


def estimate_overhead(e2e_measured: Sequence[float],
                      op_sums: Sequence[float]) -> float:
    """T_overhead = mean(e2e − Σ ops) over training architectures (§4.2)."""
    diffs = np.asarray(e2e_measured, dtype=np.float64) - np.asarray(op_sums, dtype=np.float64)
    return float(np.mean(diffs))


def estimate_overhead_per_kernel(e2e_measured: Sequence[float],
                                 op_sums: Sequence[float],
                                 num_kernels: Sequence[int]) -> Tuple[float, float]:
    """Beyond-paper: least-squares fit gap ≈ a + b·num_kernels."""
    gap = np.asarray(e2e_measured, dtype=np.float64) - np.asarray(op_sums, dtype=np.float64)
    k = np.asarray(num_kernels, dtype=np.float64)
    a_mat = np.stack([np.ones_like(k), k], axis=1)
    coef, *_ = np.linalg.lstsq(a_mat, gap, rcond=None)
    return float(coef[0]), float(coef[1])


def estimate_affine(e2e_measured: Sequence[float],
                    op_sums: Sequence[float],
                    num_kernels: Sequence[int]) -> Tuple[float, float, float]:
    """Beyond-paper composition calibration: e2e ≈ α·Σops + a + b·K.

    α absorbs the systematic bias between isolated per-op measurements
    (min-of-repeats, warm buffers) and in-graph execution; relative-error
    weighting keeps small architectures from being ignored.
    """
    e2e = np.asarray(e2e_measured, dtype=np.float64)
    s = np.asarray(op_sums, dtype=np.float64)
    k = np.asarray(num_kernels, dtype=np.float64)
    w = 1.0 / np.maximum(e2e, 1e-12)  # scale rows → relative least squares
    a_mat = np.stack([s, np.ones_like(k), k], axis=1) * w[:, None]
    coef, *_ = np.linalg.lstsq(a_mat, e2e * w, rcond=None)
    return float(coef[0]), float(coef[1]), float(coef[2])


def mape(y_true: Sequence[float], y_pred: Sequence[float]) -> float:
    """Mean absolute percentage error (paper's L_MAPE).

    The denominator is clamped as max(|y|, 1e-12): a `y == 0` guard alone
    leaves negative-or-tiny labels dividing unprotected.
    """
    yt = np.asarray(y_true, dtype=np.float64)
    yp = np.asarray(y_pred, dtype=np.float64)
    return float(np.mean(np.abs((yp - yt) / np.maximum(np.abs(yt), 1e-12))))


def mape_per_type(records: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Per-op-type MAPE from (op_type, y_true, y_pred) records."""
    by_type: Dict[str, List[Tuple[float, float]]] = {}
    for t, yt, yp in records:
        by_type.setdefault(t, []).append((yt, yp))
    return {
        t: mape([a for a, _ in v], [b for _, b in v])
        for t, v in sorted(by_type.items())
    }
