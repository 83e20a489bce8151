"""`repro_torch.obs` — deterministic observability for the serving stack.

One `Observability` bundle ties together the four pieces every serving
component shares:

  * `MetricsRegistry` (`metrics`) — labeled counters/gauges/histograms
    with bit-stable snapshots;
  * `Tracer` + `FlightRecorder` (`tracing`) — deterministic span ids,
    ambient parenting, bounded last-N-spans fault dumps;
  * `DriftMonitor` (`drift`) — per-(setting, op type) Welford residuals
    of observed-vs-predicted latency, the recalibration trigger;
  * `export` — Prometheus text exposition of registry snapshots.

Components (`MicroBatcher`, `LatencyService`, `LatencyClient`,
`LatencyRPCServer`, `ServeEngine`) each take an optional ``obs=``;
without one they build a private quiet bundle (metrics on, tracing
off) so instrumentation is always consistent and never a conditional
in the hot path.  Passing ONE bundle to every layer is what makes the
``metrics`` RPC endpoint's snapshot account for the whole system.

A training step (`repro_torch.distributed.make_train_step`) takes
``obs=`` too; without one it uses the process-wide `default()` bundle,
whose tracer is off, so the step's spans are recorded there only while a
torch.profiler session records (`tracing.train_step`).

Port notes (copy of ``repro.obs``): metric names, span names and the
Prometheus exposition are the reference's, letter for letter, and every
component above has its port (`repro_torch.rpc`, `repro_torch.pipeline`,
`repro_torch.serving`), so the ``rpc_*`` HELP entries name metrics the
port emits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.alerts import AlertEngine, AlertRule, AuditLog
from repro_torch.obs.autopilot import AutopilotConfig, RecalibrationAutopilot
from repro_torch.obs.drift import DriftMonitor, Welford, attach_session_drift
from repro_torch.obs.export import METRIC_HELP, snapshot_to_json, to_prometheus
from repro_torch.obs.metrics import (DEFAULT_SIZE_BUCKETS, DEFAULT_TIME_BUCKETS,
                               MetricsRegistry, log_buckets)
from repro_torch.obs.timeline import MetricsTimeline
from repro_torch.obs.tracing import (FlightRecorder, Span, Tracer, validate_dump,
                               NOOP_SPAN)

__all__ = [
    "Observability", "MetricsRegistry", "Tracer", "Span", "FlightRecorder",
    "DriftMonitor", "Welford", "attach_session_drift", "log_buckets",
    "DEFAULT_TIME_BUCKETS", "DEFAULT_SIZE_BUCKETS", "to_prometheus",
    "snapshot_to_json", "validate_dump", "NOOP_SPAN", "MetricsTimeline",
    "AlertRule", "AlertEngine", "AuditLog", "METRIC_HELP",
    "AutopilotConfig", "RecalibrationAutopilot", "default",
]


class Observability:
    """Registry + tracer + flight recorder + drift monitor, one handle."""

    def __init__(self, *, clock: Any = None, seed: int = 0,
                 tracing: bool = True, recorder_capacity: int = 256,
                 span_capacity: int = 4096,
                 drift_threshold: float = 0.25, drift_min_count: int = 8):
        self.registry = MetricsRegistry()
        self.recorder = FlightRecorder(capacity=recorder_capacity)
        self.tracer = Tracer(clock=clock, seed=seed, recorder=self.recorder,
                             enabled=tracing, capacity=span_capacity)
        self.drift = DriftMonitor(threshold=drift_threshold,
                                  min_count=drift_min_count)
        self.registry.collect("drift", self.drift.snapshot)
        self.registry.collect("flight_recorder", self.recorder.stats)

    @classmethod
    def quiet(cls) -> "Observability":
        """The component-private default: metrics accumulate (stats()
        views need them), tracing/span machinery stays off."""
        return cls(tracing=False)

    def instance(self, kind: str) -> str:
        return self.registry.instance(kind)

    def now(self) -> float:
        return self.tracer.now()

    def dump(self, reason: str, **attrs: Any) -> Dict[str, Any]:
        """Flight-recorder dump + a counter so snapshots show fault
        frequency, not just the last dump."""
        self.registry.inc("obs_flight_dumps_total", reason=reason)
        return self.recorder.dump(reason, attrs)

    def snapshot(self, include_collected: bool = True) -> Dict[str, Any]:
        return self.registry.snapshot(include_collected)

    def snapshot_json(self, include_collected: bool = True) -> str:
        return self.registry.snapshot_json(include_collected)

    def prometheus(self) -> str:
        return to_prometheus(self.registry.snapshot(include_collected=False))


_DEFAULT: Optional[Observability] = None


def default() -> Observability:
    """The process-wide bundle of the components that are given none
    (the training step): quiet, so its tracer holds only the spans of
    steps traced under torch.profiler."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Observability.quiet()
    return _DEFAULT
