"""Dataset build + cache + predictor-bank training (paper §4.3, §5).

The dataset maps (setting → [ArchRecord]) and caches to JSON so the
expensive profiling pass runs once.  `fit_predictor_bank` trains one
per-op-type predictor (paper §4.2) and estimates T_overhead from the
training architectures.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.composition import PredictorBank, estimate_overhead
from repro_torch.core.nas_space import NASSpaceConfig, sample_dataset
from repro_torch.core.profiler import ArchRecord
from repro_torch.core.predictors import PREDICTORS, Predictor
from repro_torch.utils.logging import get_logger

log = get_logger("repro.dataset")


@dataclass
class LatencyDataset:
    """Profiled measurements for one device setting."""

    setting: str
    archs: List[ArchRecord] = field(default_factory=list)
    # Cached one-pass (X, y) assembly keyed on (n archs, subset); see
    # `op_tables` — cleared implicitly when `archs` grows.
    _tables: Dict[Any, Dict[str, Tuple[np.ndarray, np.ndarray]]] = \
        field(default_factory=dict, repr=False, compare=False)

    # -- serialization --------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"setting": self.setting, "archs": [a.to_json() for a in self.archs]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "LatencyDataset":
        return cls(d["setting"], [ArchRecord.from_json(a) for a in d["archs"]])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "LatencyDataset":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- views -----------------------------------------------------------------
    def op_tables(self, arch_subset: Optional[Sequence[int]] = None
                  ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """(X, y) per op type over (a subset of) architectures — one pass.

        Training a bank used to call `op_table` once per op type, each
        rescanning every op of every arch (O(types × ops)); this
        assembles all type matrices in a single O(ops) sweep and caches
        the result, so retrains and multi-family training reuse it.
        """
        key = (len(self.archs),
               None if arch_subset is None else tuple(arch_subset))
        cached = self._tables.get(key)
        if cached is not None:
            return cached
        xs: Dict[str, list] = {}
        ys: Dict[str, list] = {}
        idxs = range(len(self.archs)) if arch_subset is None else arch_subset
        for i in idxs:
            for op in self.archs[i].ops:
                xs.setdefault(op.op_type, []).append(op.features)
                ys.setdefault(op.op_type, []).append(op.latency_s)
        tables = {t: (np.asarray(xs[t], dtype=np.float64),
                      np.asarray(ys[t], dtype=np.float64))
                  for t in xs}
        self._tables.clear()        # keep at most the latest assembly
        self._tables[key] = tables
        return tables

    def op_table(self, op_type: str,
                 arch_subset: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(X, y) of all ops of one type across (a subset of) architectures."""
        table = self.op_tables(arch_subset).get(op_type)
        if table is None:
            return np.zeros((0, 0)), np.zeros((0,))
        return table

    def op_types(self) -> List[str]:
        types = set()
        for a in self.archs:
            for op in a.ops:
                types.add(op.op_type)
        return sorted(types)

    def e2e(self, arch_subset: Optional[Sequence[int]] = None) -> np.ndarray:
        idxs = range(len(self.archs)) if arch_subset is None else arch_subset
        return np.asarray([self.archs[i].e2e_s for i in idxs])


def synthetic_graphs(n: int, resolution: int = 32, seed0: int = 0):
    return sample_dataset(n, NASSpaceConfig(resolution=resolution), seed0=seed0)


# ---------------------------------------------------------------------------
# Predictor-bank training (paper §4.2 + §5)
# ---------------------------------------------------------------------------

FAST_HPARAMS: Dict[str, Dict[str, Any]] = {
    # Reduced grids for the 1-core budget; full grids via benchmarks --full-grid.
    "lasso": {},
    "rf": {"n_trees": 10, "min_samples_split": 2},
    "gbdt": {"n_stages": 150, "min_samples_split": 2},
    "mlp": {"hidden_layers": 3, "width": 128, "max_epochs": 800},
}


def fit_predictor_bank(
    ds: LatencyDataset,
    predictor: str = "gbdt",
    train_idx: Optional[Sequence[int]] = None,
    hparams: Optional[Dict[str, Any]] = None,
    min_samples: int = 5,
    seed: int = 0,
    overhead_model: str = "constant",
) -> PredictorBank:
    """Train one predictor per op type on the given architecture subset."""
    if train_idx is None:
        train_idx = list(range(len(ds.archs)))
    hp = dict(FAST_HPARAMS.get(predictor, {}))
    hp.update(hparams or {})
    bank = PredictorBank(setting=ds.setting)
    for op_type, (x, y) in sorted(ds.op_tables(train_idx).items()):
        if len(y) < min_samples or x.shape[1] == 0:
            continue
        model: Predictor = PREDICTORS.get(predictor)(seed=seed, **hp)
        try:
            model.fit(x, y)
        except Exception as e:  # pragma: no cover - robustness on tiny data
            log.warning("fit failed for %s/%s: %s", predictor, op_type, e)
            continue
        bank.predictors[op_type] = model
    # T_overhead from the training architectures (paper §4.2, Fig. 10).
    # NOTE: on XLA:CPU the gap is typically NEGATIVE (async dispatch
    # overlaps python-level op dispatch with compute, so e2e < Σ ops);
    # the paper's phones show a positive gap.  Either way it is a
    # constant per device setting — we apply it with its measured sign.
    e2e = [ds.archs[i].e2e_s for i in train_idx]
    sums = [ds.archs[i].op_sum_s for i in train_idx]
    if overhead_model == "per_kernel":
        from repro_torch.core.composition import estimate_overhead_per_kernel
        ks = [ds.archs[i].num_kernels for i in train_idx]
        bank.overhead, bank.overhead_per_kernel = estimate_overhead_per_kernel(e2e, sums, ks)
    elif overhead_model == "affine":
        from repro_torch.core.composition import estimate_affine
        ks = [ds.archs[i].num_kernels for i in train_idx]
        bank.op_sum_scale, bank.overhead, bank.overhead_per_kernel = \
            estimate_affine(e2e, sums, ks)
    else:
        bank.overhead = estimate_overhead(e2e, sums)
    return bank.warm()
