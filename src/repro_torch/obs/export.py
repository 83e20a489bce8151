"""Exposition formats for `MetricsRegistry` snapshots.

``to_prometheus`` renders the counters/gauges/histograms of a snapshot
in the Prometheus text exposition format (cumulative ``_bucket{le=}``
series, ``_sum``/``_count``, ``+Inf``), deterministically ordered so
the text of two identical snapshots is byte-identical.  Every metric
family gets a ``# HELP`` line sourced from `METRIC_HELP` (with a
deterministic underscores-to-spaces fallback for names the map doesn't
know) followed by its ``# TYPE`` line.  When the caller supplies a
scrape time (``now=``), a trailing ``repro_scrape_timestamp_seconds``
gauge stamps the exposition — under an injected `ManualClock` that
stamp is a tick count, so even timestamped scrapes replay
byte-identically.  Collector sections are JSON-shaped stats dicts, not
time series — they are not exported to Prometheus (scrape the JSON
snapshot for those).
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

__all__ = ["to_prometheus", "snapshot_to_json", "METRIC_HELP"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# Descriptions for the serving stack's well-known metric families; the
# exposition falls back to a name-derived phrase for anything absent so
# HELP output stays total and deterministic either way.
METRIC_HELP: Dict[str, str] = {
    "obs_flight_dumps_total": "Flight-recorder fault dumps taken, by reason.",
    "rpc_batcher_submitted_total": "Requests admitted into the micro-batcher.",
    "rpc_batcher_answered_total": "Requests resolved by a batcher flush.",
    "rpc_batcher_failed_total": "Requests failed by the batcher.",
    "rpc_batcher_shed_total": "Requests shed by admission control, by tier.",
    "rpc_batcher_cache_hits_total": "Requests answered from the report cache.",
    "rpc_batcher_flushes_total": "Batcher flushes executed.",
    "rpc_batcher_queue_depth": "Current batcher queue depth.",
    "rpc_batcher_flush_batch_size": "Graphs coalesced per flush.",
    "rpc_batcher_flush_duration": "Wall time of one batcher flush.",
    "rpc_client_requests_total": "Client requests sent, by method.",
    "rpc_client_reconnects_total": "Client transparent reconnects.",
    "rpc_client_retries_total": "Client retries of retryable envelopes.",
    "rpc_client_timeouts_total": "Client waits that hit their deadline.",
    "rpc_batcher_max_batch": "Largest flush the batcher has executed.",
    "serve_steps_total": "Decode steps executed by the serve engine.",
    "serve_step_duration": "Wall time of one serve decode step.",
    "service_requests_total": "Prediction requests served by the service.",
    "service_cache_hits_total": "Service fingerprint-cache hits.",
    "service_cache_misses_total": "Service fingerprint-cache misses.",
    "service_batch_rows_total": "Feature rows scored by predict_batch.",
    "service_predict_batch_calls_total": "predict_batch invocations.",
    "service_backend_runs_total": "Predictor kernel runs, by backend.",
    "service_device_fused_runs_total": "Device-resident fused scoring runs.",
    "repro_scrape_timestamp_seconds":
        "Clock reading at exposition time (injectable clock units).",
}


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _help_text(name: str) -> str:
    return METRIC_HELP.get(name, name.replace("_", " ") + ".")


def _prom_labels(label_key: str, extra: str = "") -> str:
    """Our canonical ``k=v,k2=v2`` label string → ``{k="v",k2="v2"}``."""
    parts: List[str] = []
    if label_key:
        for pair in label_key.split(","):
            k, _, v = pair.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            parts.append(f'{_prom_name(k)}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: Any) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def to_prometheus(snapshot: Dict[str, Any],
                  now: Optional[float] = None) -> str:
    lines: List[str] = []

    def head(name: str, kind: str) -> str:
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} {_help_text(name)}")
        lines.append(f"# TYPE {pname} {kind}")
        return pname

    for name in sorted(snapshot.get("counters", {})):
        pname = head(name, "counter")
        series = snapshot["counters"][name]
        for key in sorted(series):
            lines.append(f"{pname}{_prom_labels(key)} {_fmt(series[key])}")
    for name in sorted(snapshot.get("gauges", {})):
        pname = head(name, "gauge")
        series = snapshot["gauges"][name]
        for key in sorted(series):
            lines.append(f"{pname}{_prom_labels(key)} {_fmt(series[key])}")
    for name in sorted(snapshot.get("histograms", {})):
        pname = head(name, "histogram")
        series = snapshot["histograms"][name]
        for key in sorted(series):
            h = series[key]
            cum = 0
            for edge, c in zip(h["buckets"], h["counts"]):
                cum += c
                le = _prom_labels(key, f'le="{_fmt(edge)}"')
                lines.append(f"{pname}_bucket{le} {cum}")
            le = _prom_labels(key, 'le="+Inf"')
            lines.append(f"{pname}_bucket{le} {h['count']}")
            lines.append(f"{pname}_sum{_prom_labels(key)} {_fmt(h['sum'])}")
            lines.append(f"{pname}_count{_prom_labels(key)} {h['count']}")
    if now is not None:
        pname = head("repro_scrape_timestamp_seconds", "gauge")
        lines.append(f"{pname} {_fmt(float(now))}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_to_json(snapshot: Dict[str, Any]) -> str:
    """Canonical one-line encoding (bit-stable determinism checks)."""
    return json.dumps(snapshot, sort_keys=True, separators=(",", ":"))
