"""Bounded time-series ring over metrics-registry scalars.

A single registry snapshot answers "what is the drift score *now*" —
but alerting needs *trends*: is the score rising, is the shed tier
flapping, has flush p99 been burning for three straight windows.
`MetricsTimeline` closes that gap deterministically:

  * **probes** — named zero-arg callables returning one float each
    (helpers read a `MetricsRegistry` counter total, gauge, or
    histogram quantile), registered once and read together;
  * **fixed-interval sampling** — `sample()` is interval-gated against
    an injectable clock (any ``.now()`` object or zero-arg callable, a
    `ManualClock` in tests), so a caller can invoke it as often as it
    likes and the ring still advances once per interval;
  * **bounded ring** — the last ``capacity`` points, thread-safe;
  * **deterministic downsampling** — `windows(name, width)` buckets a
    series into absolute-time-aligned windows (edges at integer
    multiples of ``width``) carrying min/max/last/count, so two runs
    over the same clock script produce identical window sets and no
    point is lost or double-counted;
  * **bit-stable JSON** — `to_json()`/`from_json()` round-trip the ring
    exactly (integral floats normalized to ints, canonical encoding via
    `json.dumps(sort_keys=True)` is byte-identical across runs).

The alert engine (`repro_torch.obs.alerts`) evaluates its rules against the
points this ring accumulates.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry, _num
from repro_torch.obs.tracing import _now_fn

__all__ = ["MetricsTimeline"]


class MetricsTimeline:
    """Interval-sampled, bounded ring of named scalar probes."""

    def __init__(self, *, clock: Any = None, interval: float = 1.0,
                 capacity: int = 512):
        if interval <= 0:
            raise ValueError("interval must be > 0")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.interval = float(interval)
        self.capacity = int(capacity)
        self._now = _now_fn(clock)
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], float]] = {}
        self._points: deque = deque(maxlen=self.capacity)
        self._last_t: Optional[float] = None
        self.samples = 0               # points actually recorded
        self.skipped = 0               # sample() calls inside the interval
        self.probe_errors = 0          # probe reads that raised (value omitted)

    # -- probes ---------------------------------------------------------------
    def track(self, name: str, fn: Callable[[], float]) -> None:
        """Register a named scalar probe (replaces an existing name)."""
        if not callable(fn):
            raise TypeError(f"probe {name!r} must be callable")
        with self._lock:
            self._probes[str(name)] = fn

    def track_counter(self, registry: MetricsRegistry, metric: str,
                      name: Optional[str] = None, **labels: Any) -> None:
        """Probe = summed counter total over matching label series."""
        self.track(name or metric, lambda: registry.total(metric, **labels))

    def track_gauge(self, registry: MetricsRegistry, metric: str,
                    name: Optional[str] = None, **labels: Any) -> None:
        self.track(name or metric, lambda: registry.get(metric, **labels))

    def track_quantile(self, registry: MetricsRegistry, metric: str,
                       q: float, name: Optional[str] = None,
                       **labels: Any) -> None:
        """Probe = histogram quantile (e.g. flush-latency p99 for SLO
        burn rules)."""
        self.track(name or f"{metric}_p{int(round(q * 100))}",
                   lambda: registry.hist_quantile(metric, q, **labels))

    def probe_names(self) -> List[str]:
        with self._lock:
            return sorted(self._probes)

    # -- sampling -------------------------------------------------------------
    def sample(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """Read every probe into one timestamped point, interval-gated.

        Returns the recorded point, or None when the call landed inside
        the current interval (``force=True`` bypasses the gate).  Probes
        run outside the ring lock — a probe may itself read a locked
        registry — and a raising probe omits its value (counted in
        ``probe_errors``) instead of killing the sampler.
        """
        t = self._now()
        with self._lock:
            if (not force and self._last_t is not None
                    and t - self._last_t < self.interval):
                self.skipped += 1
                return None
            probes = list(self._probes.items())
        values: Dict[str, Any] = {}
        errors = 0
        for name, fn in probes:
            try:
                values[name] = _num(float(fn()))
            except Exception:
                errors += 1
        point = {"t": _num(t), "v": values}
        with self._lock:
            self._points.append(point)
            self._last_t = t
            self.samples += 1
            self.probe_errors += errors
        return point

    # -- reads ----------------------------------------------------------------
    def points(self) -> List[Dict[str, Any]]:
        """All retained points, oldest first."""
        with self._lock:
            return list(self._points)

    def points_since(self, n: int) -> Any:
        """``(points recorded after the first n samples, new total)`` —
        one atomic read, the alert engine's incremental-consumption
        primitive (ring eviction accounted for)."""
        with self._lock:
            evicted = self.samples - len(self._points)
            start = max(0, int(n) - evicted)
            return list(self._points)[start:], self.samples

    def series(self, name: str) -> List[Any]:
        """``[(t, value), ...]`` for one probe (points missing it skip)."""
        with self._lock:
            return [(p["t"], p["v"][name]) for p in self._points
                    if name in p["v"]]

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            for p in reversed(self._points):
                if name in p["v"]:
                    return float(p["v"][name])
        return None

    def windows(self, name: str, width: float) -> List[Dict[str, Any]]:
        """Downsample one series into absolute-aligned windows.

        Window ``i`` covers ``[i*width, (i+1)*width)`` — edges depend
        only on ``width``, never on which point arrived first, so two
        runs bucket identically.  Each retained point lands in exactly
        one window (conservation: window counts sum to the series
        length); empty windows are omitted.  Per window: start/end
        edges, min/max/last values, count.
        """
        if width <= 0:
            raise ValueError("width must be > 0")
        out: List[Dict[str, Any]] = []
        for t, v in self.series(name):
            idx = int(t // width)
            v = float(v)
            if out and out[-1]["_idx"] == idx:
                w = out[-1]
                w["min"] = min(w["min"], v)
                w["max"] = max(w["max"], v)
                w["last"] = v
                w["count"] += 1
            else:
                out.append({"_idx": idx, "start": _num(idx * width),
                            "end": _num((idx + 1) * width),
                            "min": v, "max": v, "last": v, "count": 1})
        for w in out:
            del w["_idx"]
            w["min"] = _num(w["min"])
            w["max"] = _num(w["max"])
            w["last"] = _num(w["last"])
        return out

    # -- JSON round-trip ------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {"interval": _num(self.interval),
                    "capacity": self.capacity,
                    "samples": self.samples,
                    "points": [{"t": p["t"], "v": dict(p["v"])}
                               for p in self._points]}

    @classmethod
    def from_json(cls, d: Dict[str, Any], *,
                  clock: Any = None) -> "MetricsTimeline":
        tl = cls(clock=clock, interval=float(d["interval"]),
                 capacity=int(d["capacity"]))
        for p in d.get("points", []):
            tl._points.append({"t": _num(float(p["t"])),
                               "v": {k: _num(float(v))
                                     for k, v in p["v"].items()}})
        if tl._points:
            tl._last_t = float(tl._points[-1]["t"])
        tl.samples = int(d.get("samples", len(tl._points)))
        return tl

    def json_text(self) -> str:
        """Canonical encoding — byte-compare two replays for identity."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"points": len(self._points), "samples": self.samples,
                    "skipped": self.skipped, "probes": len(self._probes),
                    "probe_errors": self.probe_errors}
