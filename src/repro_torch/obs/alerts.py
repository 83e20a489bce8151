"""Declarative alert rules evaluated against a `MetricsTimeline`.

An `AlertRule` is threshold + sustain + hysteresis over one timeline
series::

    AlertRule("drift", series="drift_score", threshold=1.0, sustain=3,
              clear_threshold=0.5)

fires after ``drift_score > 1.0`` on three *consecutive* points and —
hysteresis — stays firing until the value falls to ``<= 0.5`` (not
merely back under 1.0), at which point a "clear" event emits and the
rule re-arms.  Comparison is strict: a value exactly at the threshold
does not qualify.  ``max_gap`` resets a partly-accumulated sustain
streak when the series goes quiet longer than the gap (a stalled
sampler must not stitch two separate excursions into one).

SLO burn-rate rules need no special machinery: track the flush-latency
histogram's p99 as a timeline probe (`track_quantile`) and alert on it
like any other series; delta-mode rules (``mode="delta"``) compare the
per-point increase instead of the level — the shape of an error-budget
burn rule over a monotone counter such as ``shed_tier`` flips or
timeout totals.

The `AlertEngine` walks new timeline points in order through every
rule and turns transitions into typed `AlertEvent` dicts — trace-linked
(each event is a zero-duration span; its tid/sid land in the event),
appended to a bounded `AuditLog`, mirrored into the FlightRecorder on
fire (``obs.dump("alert")``), and pushed to subscribers (the
recalibration autopilot).  Everything is deterministic under a
`ManualClock`: same clock script + same probe values → byte-identical
audit log.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.metrics import _num
from repro_torch.obs.timeline import MetricsTimeline

__all__ = ["AlertRule", "AlertEngine", "AuditLog"]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
}


class AlertRule:
    """One declarative rule; state lives in the engine, not here."""

    def __init__(self, name: str, *, series: str, threshold: float,
                 op: str = ">", sustain: int = 1,
                 clear_threshold: Optional[float] = None,
                 severity: str = "warn", mode: str = "value",
                 max_gap: Optional[float] = None):
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if sustain < 1:
            raise ValueError("sustain must be >= 1")
        if mode not in ("value", "delta"):
            raise ValueError(f"mode must be 'value' or 'delta', got {mode!r}")
        if clear_threshold is not None:
            # Hysteresis must widen the band, not invert it.
            if op == ">" and clear_threshold > threshold:
                raise ValueError("clear_threshold must be <= threshold "
                                 "for op '>'")
            if op == "<" and clear_threshold < threshold:
                raise ValueError("clear_threshold must be >= threshold "
                                 "for op '<'")
        self.name = str(name)
        self.series = str(series)
        self.threshold = float(threshold)
        self.op = op
        self.sustain = int(sustain)
        self.clear_threshold = (None if clear_threshold is None
                                else float(clear_threshold))
        self.severity = str(severity)
        self.mode = mode
        self.max_gap = None if max_gap is None else float(max_gap)

    def breaches(self, value: float) -> bool:
        """Strict comparison — exactly-at-threshold does NOT qualify."""
        return _OPS[self.op](value, self.threshold)

    def cleared(self, value: float) -> bool:
        """While firing: has the value crossed back past the clear
        level (threshold itself when no hysteresis is configured)?"""
        clear = (self.threshold if self.clear_threshold is None
                 else self.clear_threshold)
        return not _OPS[self.op](value, clear)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "series": self.series,
                "threshold": _num(self.threshold), "op": self.op,
                "sustain": self.sustain,
                "clear_threshold": (None if self.clear_threshold is None
                                    else _num(self.clear_threshold)),
                "severity": self.severity, "mode": self.mode,
                "max_gap": (None if self.max_gap is None
                            else _num(self.max_gap))}


class _RuleState:
    __slots__ = ("streak", "firing", "last_t", "last_value")

    def __init__(self) -> None:
        self.streak = 0
        self.firing = False
        self.last_t: Optional[float] = None
        self.last_value: Optional[float] = None


class AuditLog:
    """Bounded, thread-safe, sequence-numbered event log.

    Every control-plane decision (alert fire/clear, autopilot plan /
    recalibrate / rollover / suppression) lands here as one JSON-able
    dict with a monotone ``seq`` — the artifact from which a closed-loop
    run is reconstructed and bit-compared across replays.
    """

    def __init__(self, capacity: int = 1024):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._seq = 0
        self.dropped = 0

    def record(self, kind: str, t: float, **fields: Any) -> Dict[str, Any]:
        ev = {"seq": 0, "kind": str(kind), "t": _num(float(t))}
        for k, v in sorted(fields.items()):
            ev[k] = v
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self.dropped += 1
            self._events.append(ev)
        return ev

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def json_text(self) -> str:
        """Canonical encoding for replay bit-comparison."""
        return json.dumps(self.events(), sort_keys=True,
                          separators=(",", ":"))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"events": len(self._events), "seq": self._seq,
                    "dropped": self.dropped}


class AlertEngine:
    """Evaluates rules over a timeline's new points; emits AlertEvents."""

    def __init__(self, timeline: MetricsTimeline,
                 rules: Optional[List[AlertRule]] = None, *,
                 obs: Any = None, audit: Optional[AuditLog] = None,
                 audit_capacity: int = 1024):
        self.timeline = timeline
        self.obs = obs
        self.audit = audit or AuditLog(capacity=audit_capacity)
        self._rules: List[AlertRule] = []
        self._state: Dict[str, _RuleState] = {}
        self._subs: List[Callable[[Dict[str, Any]], None]] = []
        self._lock = threading.Lock()
        self._consumed = 0             # timeline points already evaluated
        for r in rules or []:
            self.add_rule(r)

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if any(r.name == rule.name for r in self._rules):
                raise ValueError(f"duplicate rule name {rule.name!r}")
            self._rules.append(rule)
            self._state[rule.name] = _RuleState()

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """``fn(event)`` runs synchronously for every emitted event —
        the autopilot's trigger path."""
        with self._lock:
            self._subs.append(fn)

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._state.items() if s.firing)

    # -- evaluation -----------------------------------------------------------
    def evaluate(self) -> List[Dict[str, Any]]:
        """Run every rule over the timeline points not yet consumed;
        returns the events emitted (possibly empty)."""
        with self._lock:
            fresh, total = self.timeline.points_since(self._consumed)
            self._consumed = total
            rules = list(self._rules)
        events: List[Dict[str, Any]] = []
        for point in fresh:
            for rule in rules:
                ev = self._step_rule(rule, point)
                if ev is not None:
                    events.append(ev)
        return events

    def _step_rule(self, rule: AlertRule,
                   point: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        raw = point["v"].get(rule.series)
        if raw is None:
            return None                  # series absent from this point
        t = float(point["t"])
        st = self._state[rule.name]
        value = float(raw)
        if rule.mode == "delta":
            prev = st.last_value
            st.last_value = value
            if prev is None:
                st.last_t = t
                return None
            value = value - prev
        # Sustain accumulates over *consecutive* points: a gap longer
        # than max_gap means the excursion ended — start counting over.
        if (rule.max_gap is not None and st.last_t is not None
                and t - st.last_t > rule.max_gap):
            st.streak = 0
        st.last_t = t
        if st.firing:
            if rule.cleared(value):
                st.firing = False
                st.streak = 0
                return self._emit(rule, "clear", t, value)
            return None
        if rule.breaches(value):
            st.streak += 1
            if st.streak >= rule.sustain:
                st.firing = True
                return self._emit(rule, "fire", t, value)
        else:
            st.streak = 0
        return None

    def _emit(self, rule: AlertRule, kind: str, t: float,
              value: float) -> Dict[str, Any]:
        event: Dict[str, Any] = {
            "rule": rule.name, "series": rule.series, "kind": kind,
            "severity": rule.severity, "t": _num(t), "value": _num(value),
            "threshold": _num(rule.threshold), "tid": None, "sid": None,
        }
        if self.obs is not None:
            span = self.obs.tracer.start_span(
                f"alert.{kind}", attrs={"rule": rule.name,
                                        "series": rule.series,
                                        "value": _num(value)})
            span.end()
            if getattr(span, "trace_id", None) is not None:
                event["tid"] = span.trace_id
                event["sid"] = span.span_id
            if kind == "fire":
                self.obs.dump("alert", rule=rule.name, series=rule.series,
                              value=_num(value))
        self.audit.record(f"alert.{kind}", t, rule=rule.name,
                          series=rule.series, value=_num(value),
                          severity=rule.severity, tid=event["tid"],
                          sid=event["sid"])
        for fn in list(self._subs):
            fn(event)
        return event

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            firing = sorted(n for n, s in self._state.items() if s.firing)
            return {"rules": len(self._rules), "firing": firing,
                    "consumed": self._consumed,
                    "audit": self.audit.stats()}
