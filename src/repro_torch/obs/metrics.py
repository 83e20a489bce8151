"""Deterministic, thread-safe metrics registry for the serving stack.

One `MetricsRegistry` per process (or per test) accumulates labeled
counters, gauges, and fixed-boundary histograms behind a single lock.
Everything about it is built for *replayable* observability:

  * histogram boundaries are fixed at registration (log-spaced by
    default, `log_buckets`), so two runs of the same workload fill the
    same slots — quantile *estimates* come from bucket counts and are
    exact to within one bucket's width;
  * `snapshot()` is a pure-JSON dict with sorted label strings and
    int-normalized integral floats, and `snapshot_json()` encodes it
    canonically (sorted keys, no whitespace) — byte-equality of two
    snapshots is a meaningful determinism check;
  * no wall-clock anywhere: durations are whatever the caller's
    injectable clock observed.  The registry itself never reads time.

``collect(name, fn)`` registers a *collector* — a zero-arg callable
returning a JSON-able dict, pulled at snapshot time.  This is how the
repo's pre-existing ``stats()`` dicts (chaos plan, profile store,
profiler session, tree-gather residency) join the one snapshot without
rewriting their internals.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "log_buckets", "DEFAULT_TIME_BUCKETS",
           "DEFAULT_SIZE_BUCKETS"]


def log_buckets(lo: float, hi: float, n: int = 24) -> Tuple[float, ...]:
    """``n`` geometrically spaced bucket upper bounds from ``lo`` to
    ``hi`` inclusive.  Pure-python floats, so boundaries are identical
    across runs and platforms."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError("log_buckets needs 0 < lo < hi and n >= 2")
    ratio = hi / lo
    return tuple(lo * ratio ** (i / (n - 1)) for i in range(n))


# Seconds: 1 µs .. 10 s, six buckets per decade.
DEFAULT_TIME_BUCKETS = log_buckets(1e-6, 10.0, 43)
# Batch/queue sizes: 1 .. 4096, one bucket per power of two.
DEFAULT_SIZE_BUCKETS = log_buckets(1.0, 4096.0, 13)


def _num(v: float) -> Any:
    """JSON-normalize: integral floats become ints (bit-stable text)."""
    f = float(v)
    return int(f) if f.is_integer() and abs(f) < 2 ** 53 else f


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of collector output to pure JSON types."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        return _num(obj)
    if hasattr(obj, "item"):                    # numpy scalar
        return _jsonable(obj.item())
    return str(obj)


class _Hist:
    """Fixed-boundary histogram: bucket ``i`` holds values in
    ``(edges[i-1], edges[i]]``; the last slot is overflow."""

    __slots__ = ("edges", "counts", "sum", "count", "vmin", "vmax")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile from bucket counts (linear
        interpolation within the containing bucket — error is bounded
        by that bucket's width)."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        target = q * (self.count - 1)           # numpy 'linear' position
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if target < cum + c:
                lo = self.edges[i - 1] if i > 0 else (self.vmin or 0.0)
                hi = self.edges[i] if i < len(self.edges) else (self.vmax or lo)
                lo = max(lo, self.vmin if self.vmin is not None else lo)
                hi = min(hi, self.vmax if self.vmax is not None else hi)
                if hi <= lo:
                    return float(lo)
                frac = (target - cum + 0.5) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum += c
        return float(self.vmax or 0.0)          # pragma: no cover

    def to_json(self) -> Dict[str, Any]:
        return {
            "buckets": [_num(e) for e in self.edges],
            "counts": list(self.counts),
            "sum": _num(self.sum),
            "count": self.count,
            "min": None if self.vmin is None else _num(self.vmin),
            "max": None if self.vmax is None else _num(self.vmax),
        }


def _label_key(labels: Dict[str, Any]) -> str:
    """Canonical label string: ``k=v`` pairs sorted by key."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class MetricsRegistry:
    """Thread-safe labeled counters / gauges / histograms + collectors."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._kinds: Dict[str, str] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        # name → label-key → value (float) or _Hist.
        self._series: Dict[str, Dict[str, Any]] = {}
        self._collectors: Dict[str, Callable[[], Any]] = {}
        self._instance_seq: Dict[str, int] = {}

    # -- registration ---------------------------------------------------------
    def _register(self, name: str, kind: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> None:
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None:
                if prev != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {prev}")
                return
            self._kinds[name] = kind
            self._series[name] = {}
            if kind == "histogram":
                self._buckets[name] = tuple(buckets or DEFAULT_TIME_BUCKETS)

    def counter(self, name: str) -> None:
        self._register(name, "counter")

    def gauge(self, name: str) -> None:
        self._register(name, "gauge")

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> None:
        self._register(name, "histogram", buckets)

    def instance(self, kind: str) -> str:
        """Deterministic per-registry instance ids: ``batcher0``,
        ``batcher1``, ... — label values for multi-component setups."""
        with self._lock:
            n = self._instance_seq.get(kind, 0)
            self._instance_seq[kind] = n + 1
            return f"{kind}{n}"

    def collect(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a stats-dict collector, pulled at snapshot time."""
        with self._lock:
            self._collectors[name] = fn

    # -- writes ---------------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        self._register(name, "counter")
        key = _label_key(labels)
        with self._lock:
            s = self._series[name]
            s[key] = s.get(key, 0.0) + value

    def set(self, name: str, value: float, **labels: Any) -> None:
        self._register(name, "gauge")
        with self._lock:
            self._series[name][_label_key(labels)] = float(value)

    def set_max(self, name: str, value: float, **labels: Any) -> None:
        self._register(name, "gauge")
        key = _label_key(labels)
        with self._lock:
            s = self._series[name]
            s[key] = max(s.get(key, float("-inf")), float(value))

    def observe(self, name: str, value: float, **labels: Any) -> None:
        self._register(name, "histogram")
        key = _label_key(labels)
        with self._lock:
            s = self._series[name]
            h = s.get(key)
            if h is None:
                h = s[key] = _Hist(self._buckets[name])
            h.observe(value)

    # -- reads ----------------------------------------------------------------
    def get(self, name: str, **labels: Any) -> float:
        with self._lock:
            s = self._series.get(name, {})
            v = s.get(_label_key(labels), 0.0)
            return float(v) if not isinstance(v, _Hist) else float(v.count)

    def labeled_values(self, name: str, label: str,
                       **filter_labels: Any) -> Dict[str, float]:
        """``{label value → summed counter/gauge}`` over every series of
        ``name`` whose labels include ``filter_labels``."""
        want = sorted(filter_labels.items())
        out: Dict[str, float] = {}
        with self._lock:
            for key, v in self._series.get(name, {}).items():
                if isinstance(v, _Hist):
                    continue
                pairs = dict(p.split("=", 1) for p in key.split(",") if p)
                if any(pairs.get(k) != str(val) for k, val in want):
                    continue
                if label in pairs:
                    lv = pairs[label]
                    out[lv] = out.get(lv, 0.0) + float(v)
        return out

    def total(self, name: str, **filter_labels: Any) -> float:
        """Sum of a counter/gauge over every matching label series."""
        want = sorted(filter_labels.items())
        tot = 0.0
        with self._lock:
            for key, v in self._series.get(name, {}).items():
                if isinstance(v, _Hist):
                    continue
                pairs = dict(p.split("=", 1) for p in key.split(",") if p)
                if any(pairs.get(k) != str(val) for k, val in want):
                    continue
                tot += float(v)
        return tot

    def hist_quantile(self, name: str, q: float, **labels: Any) -> float:
        with self._lock:
            h = self._series.get(name, {}).get(_label_key(labels))
            return h.quantile(q) if isinstance(h, _Hist) else 0.0

    def hist_stats(self, name: str, **labels: Any) -> Dict[str, Any]:
        with self._lock:
            h = self._series.get(name, {}).get(_label_key(labels))
            if not isinstance(h, _Hist):
                return {"count": 0, "sum": 0, "min": None, "max": None}
            return {"count": h.count, "sum": _num(h.sum),
                    "min": None if h.vmin is None else _num(h.vmin),
                    "max": None if h.vmax is None else _num(h.vmax)}

    # -- snapshots ------------------------------------------------------------
    def snapshot(self, include_collected: bool = True) -> Dict[str, Any]:
        """One bit-stable JSON view of everything the registry holds."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        with self._lock:
            for name, kind in sorted(self._kinds.items()):
                series = self._series[name]
                if kind == "histogram":
                    out["histograms"][name] = {
                        k: series[k].to_json() for k in sorted(series)}
                else:
                    dest = out["counters" if kind == "counter" else "gauges"]
                    dest[name] = {k: _num(series[k]) for k in sorted(series)}
            collectors = sorted(self._collectors.items())
        if include_collected:
            collected: Dict[str, Any] = {}
            for name, fn in collectors:
                try:
                    collected[name] = _jsonable(fn())
                except Exception as exc:          # collector must not kill
                    collected[name] = {"error": f"{type(exc).__name__}: {exc}"}
            out["collected"] = collected
        return out

    def snapshot_json(self, include_collected: bool = True) -> str:
        """Canonical encoding — byte-compare two runs for determinism."""
        return json.dumps(self.snapshot(include_collected),
                          sort_keys=True, separators=(",", ":"))
