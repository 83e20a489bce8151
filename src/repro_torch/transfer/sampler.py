"""Budgeted selection of source ops to re-profile on a target device.

The transfer premise (paper §6; "One Proxy Device Is Enough"): the
source ProfileStore holds thousands of measured op configs, but the
target device grants only K measurements.  Which K?

Two stages, both deterministic given a seed:

1. **Coverage first** — round-robin over op types, and within each type
   over quantile strata of (predicted or measured) latency, so every
   predictor in the bank gets calibration pairs spanning its output
   range before any type gets a second helping.  A per-op-type latency
   map fit on one stratum would extrapolate badly to the others.
2. **Budget spend** — any remaining budget goes to the
   highest-predicted-latency ops not yet chosen: the ops that dominate
   end-to-end latency are the ops whose calibration error dominates
   end-to-end error.

Scores come from the source bank's per-type predictors when given
(the engine passes its source bank), else from the stored source
measurements — either way the ordering is computed once, in bulk.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.composition import PredictorBank
from repro_torch.core.profiler import DeviceSetting, OpRecord
from repro_torch.pipeline.store import ProfileStore


@dataclass
class SamplePlan:
    """The chosen ops, in measurement order, plus how they were chosen."""

    budget: int
    seed: int
    records: List[OpRecord] = field(default_factory=list)
    per_type: Dict[str, int] = field(default_factory=dict)
    n_coverage: int = 0            # picked by stage 1
    n_greedy: int = 0              # picked by stage 2

    @property
    def signatures(self) -> List[str]:
        return [r.signature for r in self.records]

    def to_json(self) -> Dict[str, Any]:
        return {"budget": self.budget, "seed": self.seed,
                "signatures": self.signatures,
                "per_type": dict(sorted(self.per_type.items())),
                "n_coverage": self.n_coverage, "n_greedy": self.n_greedy}


def _scores(records: List[OpRecord],
            bank: Optional[PredictorBank]) -> np.ndarray:
    """Predicted (bank) or measured (store) latency per record."""
    out = np.asarray([r.latency_s for r in records], dtype=np.float64)
    if bank is None:
        return out
    by_type: Dict[str, List[int]] = {}
    for i, r in enumerate(records):
        by_type.setdefault(r.op_type, []).append(i)
    for op_type, idxs in by_type.items():
        model = bank.predictors.get(op_type)
        if model is None:
            continue                 # keep measured latency as the score
        x = np.asarray([records[i].features for i in idxs], dtype=np.float64)
        out[np.asarray(idxs)] = model.predict(x)
    return out


def plan_samples(
    store: ProfileStore,
    setting: DeviceSetting,
    budget_k: int,
    *,
    bank: Optional[PredictorBank] = None,
    op_types: Optional[set] = None,
    strata: int = 4,
    seed: int = 0,
) -> SamplePlan:
    """Pick ≤ ``budget_k`` source op records to re-measure on a target.

    ``op_types`` restricts sampling to those types (the engine passes
    the source bank's — pairs for a type with no predictor to calibrate
    would be budget spent on an unused map).  ``strata`` bounds how many
    coverage picks one op type gets before the greedy stage; the plan is
    identical across runs for a fixed (store contents, bank, budget,
    op_types, strata, seed).
    """
    plan = SamplePlan(budget=int(budget_k), seed=int(seed))
    if budget_k <= 0:
        return plan
    records = store.op_records(setting)     # sorted by signature
    if op_types is not None:
        records = [r for r in records if r.op_type in op_types]
    if not records:
        return plan
    scores = _scores(records, bank)
    rng = np.random.default_rng(seed)

    # Per type: indices sorted by score ascending (stable → deterministic).
    by_type: Dict[str, List[int]] = {}
    for i, r in enumerate(records):
        by_type.setdefault(r.op_type, []).append(i)
    strata_lists: Dict[str, List[List[int]]] = {}
    for op_type, idxs in sorted(by_type.items()):
        order = sorted(idxs, key=lambda i: (scores[i], records[i].signature))
        n_bins = min(max(1, strata), len(order))
        strata_lists[op_type] = [list(b) for b in
                                 np.array_split(np.asarray(order), n_bins)]

    chosen: List[int] = []
    taken = set()

    # Stage 1 — coverage: types round-robin × strata round-robin; the
    # seeded rng picks the representative inside each stratum.
    for layer in range(max(1, strata)):
        for op_type in sorted(strata_lists):
            bins = strata_lists[op_type]
            if layer >= len(bins) or len(chosen) >= budget_k:
                continue
            bin_ = [i for i in bins[layer] if i not in taken]
            if not bin_:
                continue
            pick = bin_[int(rng.integers(len(bin_)))]
            chosen.append(pick)
            taken.add(pick)
        if len(chosen) >= budget_k:
            break
    plan.n_coverage = len(chosen)

    # Stage 2 — spend what's left on the most expensive ops.
    if len(chosen) < budget_k:
        greedy = sorted((i for i in range(len(records)) if i not in taken),
                        key=lambda i: (-scores[i], records[i].signature))
        take = greedy[:budget_k - len(chosen)]
        chosen.extend(take)
        plan.n_greedy = len(take)

    plan.records = [records[i] for i in chosen]
    for r in plan.records:
        plan.per_type[r.op_type] = plan.per_type.get(r.op_type, 0) + 1
    return plan
