"""Multi-worker latency composition + straggler model (paper Insight 1 → pods).

The paper's multithreading study (§3.1.1) shows:
  * work is split EQUALLY across threads (TFLite/Ruy);
  * heterogeneous cores ⇒ the slow core is the straggler:
        T = max_i (w/k) / s_i  =  (w/k) / min_i s_i
    which can *exceed* single-fast-core latency — the counterintuitive
    "more cores is slower" result of Fig. 2;
  * only some op types parallelize (conv/dwconv/FC); the rest run on one
    worker regardless.

We transplant this to pod scale: data-parallel groups with heterogeneous
effective throughput (thermal throttling, background daemons, degraded
HBM, failover spares).  The same equal-split pathology appears, and the
fix is the same as the paper implies: *weighted* splits sized from
predicted throughput.  `WeightedSplitPlanner` is the framework feature
(used by `repro_torch.distributed.straggler`): it consumes per-worker speed
estimates — in production, the latency predictor's per-op outputs — and
emits batch shard sizes minimizing predicted step latency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Op types that TFLite parallelizes across cores (paper Fig. 3).
PARALLELIZABLE_OPS = ("conv2d", "grouped_conv2d", "winograd_conv2d",
                      "dwconv2d", "fully_connected",
                      # LM extension: dense compute shards across chips.
                      "matmul", "attention", "flash_attention",
                      "window_attention", "moe_gmm", "ssd_scan")


@dataclass(frozen=True)
class Worker:
    """One execution lane (CPU core / chip / DP group) with relative speed."""

    name: str
    speed: float            # relative throughput (1.0 = reference)
    sync_overhead: float = 0.0  # per-op cross-lane sync cost (seconds)


def equal_split_latency(op_latency_1w: float, workers: Sequence[Worker],
                        parallelizable: bool = True) -> float:
    """Paper's observed TFLite behaviour: work split equally over k workers.

    ``op_latency_1w`` is the measured latency on ONE reference worker
    (speed 1.0).  Non-parallelizable ops run on the fastest worker.
    """
    if not workers:
        raise ValueError("need at least one worker")
    if not parallelizable or len(workers) == 1:
        return op_latency_1w / max(w.speed for w in workers)
    k = len(workers)
    per_worker = [(op_latency_1w / k) / w.speed for w in workers]
    sync = max(w.sync_overhead for w in workers)
    return max(per_worker) + sync


def weighted_split_latency(op_latency_1w: float, workers: Sequence[Worker],
                           parallelizable: bool = True) -> Tuple[float, List[float]]:
    """Optimal split: share_i ∝ speed_i ⇒ all workers finish together.

    Returns (latency, shares).  This is the planner the framework uses to
    mitigate stragglers (beyond-paper; the paper identifies the pathology,
    we close the loop).
    """
    if not parallelizable or len(workers) == 1:
        best = max(w.speed for w in workers)
        return op_latency_1w / best, [1.0 if w.speed == best else 0.0 for w in workers]
    total_speed = sum(w.speed for w in workers)
    shares = [w.speed / total_speed for w in workers]
    sync = max(w.sync_overhead for w in workers)
    return op_latency_1w / total_speed + sync, shares


def graph_latency_multiworker(
    op_records: Sequence[Tuple[str, float]],
    workers: Sequence[Worker],
    *,
    policy: str = "equal",
    overhead: float = 0.0,
) -> float:
    """End-to-end latency of sequential ops, each split across workers.

    ``op_records``: (op_type, single-worker latency) per op, in order.
    ``policy``: 'equal' (TFLite observed) or 'weighted' (our planner).
    """
    total = overhead
    for op_type, lat in op_records:
        par = op_type in PARALLELIZABLE_OPS
        if policy == "equal":
            total += equal_split_latency(lat, workers, par)
        elif policy == "weighted":
            total += weighted_split_latency(lat, workers, par)[0]
        else:
            raise ValueError(f"unknown policy {policy!r}")
    return total


def speedup_curve(op_records: Sequence[Tuple[str, float]],
                  worker_counts: Sequence[int],
                  *, speed: float = 1.0,
                  sync_overhead: float = 0.0,
                  policy: str = "equal") -> Dict[int, float]:
    """Homogeneous-core speedup curve (paper Fig. 3 reproduction)."""
    base = graph_latency_multiworker(op_records, [Worker("w0", speed)])
    out = {}
    for k in worker_counts:
        ws = [Worker(f"w{i}", speed, sync_overhead) for i in range(k)]
        out[k] = base / graph_latency_multiworker(op_records, ws, policy=policy)
    return out


class WeightedSplitPlanner:
    """Sizes per-DP-group batch shards from throughput estimates.

    Given per-group measured (or predicted) step times at equal split,
    re-plan shares so predicted finish times equalize.  Iterating once is
    exact when latency ∝ work; we expose `plan()` for the runtime and
    `microbatch_plan()` for integer microbatch counts (grad accumulation).
    """

    def __init__(self, min_share: float = 0.01):
        self.min_share = min_share

    def plan(self, step_times: Sequence[float]) -> List[float]:
        t = np.asarray(step_times, dtype=np.float64)
        if np.any(t <= 0):
            raise ValueError("step times must be positive")
        speeds = 1.0 / t
        shares = speeds / speeds.sum()
        shares = np.maximum(shares, self.min_share)
        return list(shares / shares.sum())

    def microbatch_plan(self, step_times: Sequence[float],
                        total_microbatches: int) -> List[int]:
        shares = self.plan(step_times)
        raw = [s * total_microbatches for s in shares]
        counts = [max(1, int(round(r))) for r in raw]
        # Fix rounding drift while keeping ≥1 per group.
        while sum(counts) > total_microbatches:
            i = int(np.argmax(counts))
            if counts[i] > 1:
                counts[i] -= 1
            else:
                break
        while sum(counts) < total_microbatches:
            # Give extras to the fastest group (largest share).
            i = int(np.argmax(shares))
            counts[i] += 1
        return counts

    def predicted_step(self, step_times: Sequence[float],
                       shares: Optional[Sequence[float]] = None) -> float:
        t = np.asarray(step_times, dtype=np.float64)
        k = len(t)
        if shares is None:
            shares = [1.0 / k] * k
        # step_time_i at equal split corresponds to share 1/k; scale linearly.
        return float(np.max(t * (np.asarray(shares) * k)))
