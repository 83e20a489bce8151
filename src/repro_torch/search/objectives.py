"""Search objectives: quality proxies + predicted-latency constraints.

Quality proxies stand in for task accuracy (the paper's scope is the
latency side; a real deployment plugs a trained supernet or tabular
benchmark in here through the same `QualityProxy` callable):

  * `FlopsQuality` — log total FLOPs (capacity), promoted from the old
    `examples/nas_latency_search.py` ad-hoc loop;
  * `BalancedQuality` — log FLOPs − w·log params: rewards compute
    capacity per parameter, penalizing architectures that buy FLOPs
    with parameter bloat (1×1-conv channel inflation).

Latency is scored through `LatencyScorer`: one
`LatencyService.predict_batch` call per device setting covers a whole
population (the batched fast path), and `DeviceBudget`s express the
multi-device constraint — a candidate is feasible only if it meets its
budget on *every* registered device (transfer-calibrated target banks
resolve through the same service).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.features import graph_features
from repro_torch.core.ir import OpGraph
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline.store import setting_key

QualityProxy = Callable[[OpGraph], float]


def _column_sum(graph: OpGraph, column_names: Sequence[str]) -> float:
    """Sum the named feature columns over every op of the graph."""
    gf = graph_features(graph)
    total = 0.0
    for op_type, names in gf.names.items():
        cols = [j for j, n in enumerate(names) if n in column_names]
        if cols:
            total += float(gf.matrix[op_type][:, cols].sum())
    return total


def graph_flops(graph: OpGraph) -> float:
    """Total FLOPs from the cached per-op feature matrices."""
    return _column_sum(graph, ("flops",))


def graph_params(graph: OpGraph) -> float:
    """Total parameter count (conv kernels + FC weight matrices)."""
    return _column_sum(graph, ("kernel_size", "param_size"))


class FlopsQuality:
    """log total FLOPs — the capacity proxy of the original example."""

    name = "flops"

    def __call__(self, graph: OpGraph) -> float:
        return float(np.log(max(graph_flops(graph), 1.0)))


class BalancedQuality:
    """log FLOPs − w·log params: capacity, discounted by parameter cost."""

    name = "balanced"

    def __init__(self, param_weight: float = 0.25):
        self.param_weight = float(param_weight)

    def __call__(self, graph: OpGraph) -> float:
        flops = np.log(max(graph_flops(graph), 1.0))
        params = np.log(max(graph_params(graph), 1.0))
        return float(flops - self.param_weight * params)


class SupernetQuality:
    """Weight-sharing supernet accuracy proxy for elastic populations.

    A deterministic stand-in for an OFA-style trained supernet, replacing
    the flops proxy (which rewards raw capacity and cannot rank two
    subnets of the same macro-skeleton).  Each block of the supernet
    carries a seeded per-knob importance profile; a subnet's quality is
    the fraction of supernet weight mass its knob settings inherit.
    Knobs are nested the way weight sharing nests them — kernel 3 ⊂ 5 ⊂ 7
    center crops, depth prefixes, expansion/width channel sorts — so
    quality is monotone non-decreasing in every knob with seeded
    diminishing returns per block, the partial order a trained
    weight-sharing supernet exhibits.

    Scores the *genotype* (``needs_genotype``), not the decoded graph:
    weight sharing is defined over knobs, which the flat op list no
    longer exposes.
    """

    name = "supernet"
    needs_genotype = True

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _coeffs(self, block_index: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000003 + block_index)
        return rng.uniform(0.5, 2.0, size=4)   # per-knob saturation rates

    @staticmethod
    def _cover(frac: float, rate: float) -> float:
        """Importance mass covered by keeping ``frac`` of a knob's range
        under a sorted-importance profile (saturating, normalized)."""
        return float((1.0 - np.exp(-rate * frac)) / (1.0 - np.exp(-rate)))

    def __call__(self, gt) -> float:
        if isinstance(gt, OpGraph):
            raise TypeError("SupernetQuality scores genotypes, not graphs "
                            "(needs_genotype=True)")
        total = 0.0
        for i, gene in enumerate(gt.blocks):
            ck, cd, ce, cw = self._coeffs(i)
            lo, hi = (8, 80) if i < 5 else (80, 400)
            k_frac = (gene.kernel ** 2) / 49.0          # taps kept of 7×7
            d_frac = min(max(int(gene.depth), 1), 3) / 3.0
            e_frac = min(gene.expansion, 6) / 6.0
            w_frac = min(max(gene.out_c / max(1.0, float(hi)), lo / hi), 1.0)
            total += (self._cover(k_frac, ck) * self._cover(d_frac, cd)
                      * self._cover(e_frac, ce) * self._cover(w_frac, cw))
        return total / max(1, len(gt.blocks))


QUALITIES: Dict[str, Callable[[], QualityProxy]] = {
    "flops": FlopsQuality,
    "balanced": BalancedQuality,
    "supernet": SupernetQuality,
}


def make_quality(name: str) -> QualityProxy:
    """Quality proxy by registry name (checkpoints store the name)."""
    try:
        return QUALITIES[name]()
    except KeyError:
        raise ValueError(f"unknown quality proxy {name!r}; "
                         f"known: {sorted(QUALITIES)}") from None


# ---------------------------------------------------------------------------
# Latency constraints
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceBudget:
    """A per-device latency ceiling (seconds, end-to-end)."""

    setting: DeviceSetting
    budget_s: float

    @property
    def key(self) -> str:
        return setting_key(self.setting)

    def to_json(self) -> Dict[str, Any]:
        s = self.setting
        return {"setting": {"name": s.name, "dtype": s.dtype, "mode": s.mode,
                            "device": s.device},
                "budget_s": self.budget_s}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "DeviceBudget":
        return cls(DeviceSetting(**d["setting"]), float(d["budget_s"]))


class LatencyScorer:
    """Population-scale predicted latency under multi-device budgets.

    ``score`` costs exactly one `predict_batch` call per device setting
    regardless of population size (`predict_batch_calls` counts them, so
    callers can assert the contract); ``feasible_mask`` applies every
    budget jointly.
    """

    def __init__(self, service: Any, budgets: Sequence[DeviceBudget],
                 predictor: Optional[str] = None):
        if not budgets:
            raise ValueError("need at least one DeviceBudget")
        keys = [b.key for b in budgets]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate device settings in budgets: {keys}")
        self.service = service
        self.budgets = list(budgets)
        self.predictor = predictor
        self.predict_batch_calls = 0

    @property
    def keys(self) -> List[str]:
        """Setting keys in budget order (the first is the primary device)."""
        return [b.key for b in self.budgets]

    def score(self, graphs: Sequence[OpGraph]) -> Dict[str, np.ndarray]:
        """Predicted e2e seconds per device: {setting key: (n,) array}."""
        multi = self.service.predict_multi(
            graphs, [b.setting for b in self.budgets], self.predictor)
        self.predict_batch_calls += len(self.budgets)
        return {key: np.asarray([r.e2e_s for r in reports])
                for key, reports in multi.items()}

    def feasible_mask(self, lats: Dict[str, np.ndarray]) -> np.ndarray:
        """True where a candidate meets its budget on every device."""
        mask = None
        for b in self.budgets:
            ok = lats[b.key] <= b.budget_s
            mask = ok if mask is None else (mask & ok)
        return mask

    def violation(self, lats: Dict[str, np.ndarray]) -> np.ndarray:
        """Total relative budget overshoot (0 where feasible) — the
        tie-break used to compare infeasible candidates."""
        total = None
        for b in self.budgets:
            over = np.maximum(lats[b.key] / b.budget_s - 1.0, 0.0)
            total = over if total is None else total + over
        return total
