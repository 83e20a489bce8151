"""Straggler mitigation: predictor-driven weighted work partitioning.

Paper Insight 1 (equal splits + heterogeneous lanes ⇒ stragglers) turned
into a runtime feature: the `StragglerMonitor` tracks per-DP-group step
times (EWMA), detects degraded groups, and emits a weighted microbatch
plan via `WeightedSplitPlanner` (core/distributed_model.py).  When no
measurements exist yet, the latency-predictor bank supplies the prior —
the paper's "predict without deploying" applied to scheduling.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.distributed_model import WeightedSplitPlanner
from repro_torch.utils.logging import get_logger

log = get_logger("repro.straggler")


@dataclass
class StragglerMonitor:
    n_groups: int
    ewma: float = 0.3
    degrade_threshold: float = 1.3   # flag groups >30% slower than median
    step_times: Optional[np.ndarray] = None
    planner: WeightedSplitPlanner = field(default_factory=WeightedSplitPlanner)

    def update(self, times: Sequence[float]) -> None:
        t = np.asarray(times, dtype=np.float64)
        assert t.shape == (self.n_groups,)
        if self.step_times is None:
            self.step_times = t
        else:
            self.step_times = (1 - self.ewma) * self.step_times + self.ewma * t

    def seed_from_predictions(self, predicted: Sequence[float]) -> None:
        """Initialize from latency-predictor estimates (no measurements yet)."""
        self.step_times = np.asarray(predicted, dtype=np.float64)

    def degraded_groups(self) -> List[int]:
        if self.step_times is None:
            return []
        med = float(np.median(self.step_times))
        return [i for i, t in enumerate(self.step_times)
                if t > self.degrade_threshold * med]

    def microbatch_plan(self, total_microbatches: int) -> List[int]:
        if self.step_times is None:
            base = total_microbatches // self.n_groups
            return [base] * self.n_groups
        plan = self.planner.microbatch_plan(self.step_times, total_microbatches)
        if self.degraded_groups():
            log.info("straggler plan: times=%s → microbatches=%s",
                     np.round(self.step_times, 4).tolist(), plan)
        return plan

    def predicted_speedup(self, total_microbatches: int) -> float:
        """Step-time ratio equal-split / weighted-split (the paper's Fig. 2
        pathology quantified, then fixed)."""
        if self.step_times is None:
            return 1.0
        k = self.n_groups
        per_mb = self.step_times * k / total_microbatches  # time per microbatch
        equal = float(np.max(per_mb * (total_microbatches / k)))
        plan = self.microbatch_plan(total_microbatches)
        weighted = float(np.max(per_mb * np.asarray(plan)))
        return equal / max(weighted, 1e-12)
