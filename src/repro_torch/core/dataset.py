"""Dataset build + cache + predictor-bank training (paper §4.3, §5).

The dataset maps (setting → [ArchRecord]) and caches to JSON so the
expensive profiling pass runs once.  `fit_predictor_bank` trains one
per-op-type predictor (paper §4.2) and estimates T_overhead from the
training architectures.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.composition import PredictorBank, estimate_overhead
from repro_torch.core.nas_space import NASSpaceConfig, sample_dataset
from repro_torch.core.profiler import ArchRecord, DeviceSetting, OpRecord, ProfileSession
from repro_torch.core.realworld import build_realworld_suite
from repro_torch.core.predictors import Predictor, build_predictor
from repro_torch.utils.device import DeviceLike
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


# ---------------------------------------------------------------------------
# Build / cache
# ---------------------------------------------------------------------------

def build_dataset(
    graphs,
    setting: DeviceSetting,
    cache_path: Optional[str] = None,
    session: Optional[ProfileSession] = None,
    store: Optional[Any] = None,
    device: DeviceLike = "cuda",
) -> LatencyDataset:
    """Profile ``graphs`` (or load the JSON cache) into a LatencyDataset.

    ``store`` (a `repro_torch.pipeline.ProfileStore`) makes profiling
    incremental across processes: already-measured signatures are read
    back instead of re-measured, and new measurements are persisted.
    A new session profiles on ``device``.
    """
    if cache_path and os.path.exists(cache_path):
        ds = LatencyDataset.load(cache_path)
        if len(ds.archs) >= len(graphs):
            log.info("loaded cached dataset %s (%d archs)", cache_path, len(ds.archs))
            return ds
    session = session or ProfileSession(store=store, device=device)
    if store is not None and session.store is None:
        session.store = store
    t0 = time.time()
    archs = session.profile_suite(graphs, setting)
    log.info("profiled %d archs under %s in %.0fs",
             len(archs), setting.name, time.time() - t0)
    ds = LatencyDataset(setting.name, archs)
    if cache_path:
        ds.save(cache_path)
    return ds


def synthetic_graphs(n: int, resolution: int = 32, seed0: int = 0):
    return sample_dataset(n, NASSpaceConfig(resolution=resolution), seed0=seed0)


def realworld_graphs(resolution: int = 32):
    return build_realworld_suite(resolution=resolution)


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
    device: DeviceLike = "cuda",
) -> PredictorBank:
    """Train one predictor per op type on the given architecture subset
    (device-bound families — lasso, MLP — fit on ``device``)."""
    if train_idx is None:
        train_idx = list(range(len(ds.archs)))
    hp = dict(FAST_HPARAMS.get(predictor, {}))
    hp.update(hparams or {})
    bank = PredictorBank(setting=ds.setting)
    for op_type, (x, y) in sorted(ds.op_tables(train_idx).items()):
        if len(y) < min_samples or x.shape[1] == 0:
            continue
        model: Predictor = build_predictor(predictor, device, seed=seed, **hp)
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


def evaluate_bank(
    ds: LatencyDataset,
    bank: PredictorBank,
    test_idx: Sequence[int],
) -> Dict[str, Any]:
    """End-to-end + per-op-type MAPE on test architectures (paper Fig. 14)."""
    from repro_torch.core.composition import mape, mape_per_type

    y_true, y_pred, per_op = [], [], []
    for i in test_idx:
        rec = ds.archs[i]
        pred = bank.overhead + bank.overhead_per_kernel * rec.num_kernels
        for op in rec.ops:
            model = bank.predictors.get(op.op_type)
            if model is None:
                continue
            p = float(np.maximum(model.predict(np.asarray([op.features]))[0], 0.0))
            pred += bank.op_sum_scale * p
            per_op.append((op.op_type, op.latency_s, p))
        y_true.append(rec.e2e_s)
        y_pred.append(pred)
    return {
        "e2e_mape": mape(y_true, y_pred),
        "per_op_mape": mape_per_type(per_op),
        "n_test": len(test_idx),
        "y_true": y_true,
        "y_pred": y_pred,
    }
