"""Incremental Pareto front + crowding-distance machinery (NSGA-II style).

All objectives MINIMIZE (callers negate maximization objectives).  The
front is an archive keyed by candidate digest: `add` keeps the set
non-dominated incrementally, and a bounded front prunes by crowding
distance (extreme points are never pruned; ties break on the key, so
pruning is deterministic and checkpoint/replay-stable).

`nondominated_rank` + `crowding_distance` also serve parent selection
in the evolutionary loop (crowded tournament).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff ``a`` is no worse than ``b`` everywhere, better somewhere."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return bool(np.all(a <= b) and np.any(a < b))


def nondominated_rank(points: np.ndarray) -> np.ndarray:
    """Front index per row (0 = non-dominated), by fast non-dominated sort."""
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    ranks = np.full(n, -1, dtype=np.intp)
    # dominated[i, j]: i dominates j (vectorized pairwise comparison).
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=2)
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=2)
    dom = le & lt
    dom_count = dom.sum(axis=0)          # how many dominate j
    rank = 0
    remaining = np.ones(n, dtype=bool)
    while remaining.any():
        front = remaining & (dom_count == 0)
        if not front.any():              # numerical safety: break ties flat
            front = remaining
        ranks[front] = rank
        remaining &= ~front
        dom_count = dom_count - dom[front].sum(axis=0)
        rank += 1
    return ranks


def crowding_distance(points: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance per row (∞ at each objective's extremes).

    Sorting ties break on row index, so equal points get deterministic
    (asymmetric) distances — stable across runs and platforms.
    """
    pts = np.asarray(points, dtype=np.float64)
    n, m = pts.shape
    dist = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for j in range(m):
        order = np.argsort(pts[:, j], kind="stable")
        col = pts[order, j]
        span = col[-1] - col[0]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        gaps = (col[2:] - col[:-2]) / span
        dist[order[1:-1]] += gaps
    return dist


class ParetoFront:
    """Non-dominated archive keyed by candidate digest.

    ``capacity`` (optional) bounds the archive: when exceeded, the
    lowest-crowding member is dropped (never an objective extreme).
    Members carry their objective vector plus an opaque payload.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._members: Dict[str, Tuple[np.ndarray, Any]] = {}

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, key: str) -> bool:
        return key in self._members

    def add(self, key: str, objectives: Sequence[float],
            payload: Any = None) -> bool:
        """Try to admit ``key``; returns True iff it is in the front after
        the call.  Dominated incumbents are evicted; a re-added key just
        refreshes its payload."""
        obj = np.asarray(objectives, dtype=np.float64)
        incumbent = self._members.get(key)
        if incumbent is not None:
            if np.array_equal(incumbent[0], obj):
                self._members[key] = (obj, payload)    # refresh payload
                return True
            # Re-scored key: drop it and re-run full admission so the
            # non-domination invariant survives changed objectives.
            del self._members[key]
        for eobj, _ in self._members.values():
            if dominates(eobj, obj) or np.array_equal(eobj, obj):
                return False
        evict = [k for k, (eobj, _) in self._members.items()
                 if dominates(obj, eobj)]
        for k in evict:
            del self._members[k]
        self._members[key] = (obj, payload)
        if self.capacity is not None and len(self._members) > self.capacity:
            self._prune()
        return key in self._members

    def _prune(self) -> None:
        keys = sorted(self._members)          # deterministic base order
        pts = np.stack([self._members[k][0] for k in keys])
        crowd = crowding_distance(pts)
        # Drop the least-crowded member; ties break on the digest.
        order = sorted(range(len(keys)), key=lambda i: (crowd[i], keys[i]))
        del self._members[keys[order[0]]]

    def members(self) -> List[Tuple[str, np.ndarray, Any]]:
        """(key, objectives, payload), sorted by objectives then key —
        a canonical order for reports and equality checks."""
        items = [(k, obj, payload) for k, (obj, payload) in self._members.items()]
        items.sort(key=lambda e: (tuple(e[1]), e[0]))
        return items

    def objectives(self) -> np.ndarray:
        ms = self.members()
        if not ms:
            return np.zeros((0, 0))
        return np.stack([obj for _, obj, _ in ms])

    # -- serialization --------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "members": [[k, [float(v) for v in obj], payload]
                        for k, obj, payload in self.members()],
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ParetoFront":
        front = cls(capacity=d.get("capacity"))
        for k, obj, payload in d["members"]:
            front._members[k] = (np.asarray(obj, dtype=np.float64), payload)
        return front

    def digest_equal(self, other: "ParetoFront") -> bool:
        """Bit-level equality of the member sets (determinism checks)."""
        return json.dumps(self.to_json(), sort_keys=True) == \
            json.dumps(other.to_json(), sort_keys=True)
