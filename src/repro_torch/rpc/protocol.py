"""JSON-lines wire protocol for the latency-prediction serving layer.

One message per line, UTF-8 JSON.  Requests and responses carry an
explicit protocol version (``"v"``) so wire-format drift is rejected
loudly instead of silently misread, and every failure travels as a
typed error envelope a client can switch on (``code``) and retry on
(``retryable``).

Request::

    {"v": 1, "id": "r7", "method": "predict", "params": {...}}

Response (exactly one of ``result``/``error``)::

    {"v": 1, "id": "r7", "ok": true,  "result": {...}}
    {"v": 1, "id": "r7", "ok": false, "error": {"code": "overloaded",
                                                "message": "...",
                                                "retryable": true}}

Methods (params → result):

    predict        {graph, setting?, predictor?} → {report}
    predict_multi  {graphs, settings, predictor?} → {reports: {skey: [..]}}
    available      {} → {banks: [[skey, family], ...]}
    stats          {} → {server, batcher, service}
    search_front   {setting?, budget_s?, limit?} → {setting, total, members}
    health         {} → {status, shed_tier, queued, queue_capacity,
                         hub_epoch, bank_epochs}
                         (+ metrics summary with an explicit obs bundle,
                          + autopilot status with an autopilot attached)
    rollover       {setting, family?, bank} → {setting, family, epoch}
    metrics        {format?, dumps?, timeline?, audit?, audit_kind?}
                   → {snapshot} | {text} (+ dumps/timeline/audit keys;
                     timeline/audit need a server-side autopilot)

Either envelope may carry an optional ``trace`` field —
``{"tid": <trace id>, "sid": <span id>}`` — propagating a request's
trace context across the wire (`repro_torch.obs.tracing`).  The field is
omitted entirely when absent, so peers that predate it (and the
golden files that pin v1 bytes) are unaffected.

Graphs travel as `OpGraph.to_json()`; device settings as either their
canonical key string (``"device:dtype/mode"`` / ``"dtype/mode"``) or a
``{name, dtype, mode, device}`` object; prediction reports as
`PredictionReport.to_json()`.  Encoding is canonical (sorted keys, no
whitespace) so byte-equality of re-encoded messages is a meaningful
golden-file check (tests/test_rpc.py + tests/golden/).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.ir import OpGraph
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline.service import PredictionReport
from repro_torch.pipeline.store import setting_key

PROTOCOL_VERSION = 1

METHODS = ("predict", "predict_multi", "available", "stats", "search_front",
           "health", "rollover", "metrics")

# -- typed error codes --------------------------------------------------------
E_BAD_REQUEST = "bad_request"          # malformed JSON / missing fields
E_UNKNOWN_VERSION = "unknown_version"  # protocol version mismatch
E_UNKNOWN_METHOD = "unknown_method"
E_UNKNOWN_SETTING = "unknown_setting"  # no bank / not a served device
E_BAD_GRAPH = "bad_graph"              # graph payload fails to decode/validate
E_OVERLOADED = "overloaded"            # admission control rejected (retryable)
E_UNAVAILABLE = "unavailable"          # endpoint not configured / shutting down
E_TIMEOUT = "timeout"
E_INTERNAL = "internal"

_DEFAULT_RETRYABLE = {E_OVERLOADED, E_TIMEOUT, E_UNAVAILABLE}


class RPCError(Exception):
    """A protocol-level failure with a typed, wire-serializable envelope."""

    def __init__(self, code: str, message: str, *,
                 retryable: Optional[bool] = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.retryable = (code in _DEFAULT_RETRYABLE if retryable is None
                          else bool(retryable))

    def to_json(self) -> Dict[str, Any]:
        return {"code": self.code, "message": self.message,
                "retryable": self.retryable}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RPCError":
        return cls(str(d.get("code", E_INTERNAL)),
                   str(d.get("message", "")),
                   retryable=bool(d.get("retryable", False)))


def _decode_trace(obj: Dict[str, Any]) -> Optional[Dict[str, str]]:
    """Validate an optional envelope ``trace`` field ({"tid", "sid"})."""
    trace = obj.get("trace")
    if trace is None:
        return None
    if not isinstance(trace, dict) or not isinstance(trace.get("tid"), str):
        raise RPCError(E_BAD_REQUEST,
                       "'trace' must be an object with string 'tid'")
    sid = trace.get("sid")
    if sid is not None and not isinstance(sid, str):
        raise RPCError(E_BAD_REQUEST, "'trace.sid' must be a string")
    out = {"tid": trace["tid"]}
    if sid is not None:
        out["sid"] = sid
    return out


@dataclass(frozen=True)
class Request:
    id: str
    method: str
    params: Dict[str, Any] = field(default_factory=dict)
    v: int = PROTOCOL_VERSION
    # Optional trace propagation context; never serialized when None so
    # pre-trace peers and golden bytes are untouched.
    trace: Optional[Dict[str, str]] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"v": self.v, "id": self.id,
                             "method": self.method, "params": self.params}
        if self.trace is not None:
            d["trace"] = self.trace
        return d


@dataclass(frozen=True)
class Response:
    id: Optional[str]
    ok: bool
    result: Optional[Dict[str, Any]] = None
    error: Optional[RPCError] = None
    v: int = PROTOCOL_VERSION
    trace: Optional[Dict[str, str]] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"v": self.v, "id": self.id, "ok": self.ok}
        if self.ok:
            d["result"] = self.result if self.result is not None else {}
        else:
            err = self.error or RPCError(E_INTERNAL, "unspecified error")
            d["error"] = err.to_json()
        if self.trace is not None:
            d["trace"] = self.trace
        return d


def _dumps(obj: Dict[str, Any]) -> str:
    """Canonical one-line encoding (golden files byte-compare on this)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def encode_request(req: Request) -> str:
    return _dumps(req.to_json())


def encode_response(resp: Response) -> str:
    return _dumps(resp.to_json())


def _check_version(obj: Dict[str, Any]) -> None:
    if "v" not in obj:
        raise RPCError(E_BAD_REQUEST, "missing protocol version field 'v'")
    if obj["v"] != PROTOCOL_VERSION:
        raise RPCError(
            E_UNKNOWN_VERSION,
            f"protocol version {obj['v']!r} not supported "
            f"(this end speaks v{PROTOCOL_VERSION})")


def _parse_line(line: str) -> Dict[str, Any]:
    try:
        obj = json.loads(line)
    except (json.JSONDecodeError, TypeError) as exc:
        raise RPCError(E_BAD_REQUEST, f"not valid JSON: {exc}") from None
    if not isinstance(obj, dict):
        raise RPCError(E_BAD_REQUEST,
                       f"message must be a JSON object, got {type(obj).__name__}")
    return obj


def decode_request(line: str) -> Request:
    """Parse + validate one request line; raises `RPCError` (the server
    maps it to an error envelope echoing whatever id was readable)."""
    obj = _parse_line(line)
    _check_version(obj)
    rid = obj.get("id")
    if not isinstance(rid, (str, int)) or isinstance(rid, bool):
        raise RPCError(E_BAD_REQUEST, "request 'id' must be a string or int")
    method = obj.get("method")
    if not isinstance(method, str) or not method:
        raise RPCError(E_BAD_REQUEST, "request 'method' must be a string")
    params = obj.get("params", {})
    if not isinstance(params, dict):
        raise RPCError(E_BAD_REQUEST, "request 'params' must be an object")
    return Request(id=str(rid), method=method, params=params, v=obj["v"],
                   trace=_decode_trace(obj))


def decode_response(line: str) -> Response:
    obj = _parse_line(line)
    _check_version(obj)
    rid = obj.get("id")
    ok = obj.get("ok")
    if not isinstance(ok, bool):
        raise RPCError(E_BAD_REQUEST, "response 'ok' must be a boolean")
    trace = _decode_trace(obj)
    if ok:
        result = obj.get("result")
        if not isinstance(result, dict):
            raise RPCError(E_BAD_REQUEST, "ok response must carry 'result'")
        return Response(id=None if rid is None else str(rid), ok=True,
                        result=result, v=obj["v"], trace=trace)
    err = obj.get("error")
    if not isinstance(err, dict):
        raise RPCError(E_BAD_REQUEST, "error response must carry 'error'")
    return Response(id=None if rid is None else str(rid), ok=False,
                    error=RPCError.from_json(err), v=obj["v"], trace=trace)


def request_id_of(line: str) -> Optional[str]:
    """Best-effort id extraction from a (possibly malformed) request, so
    error envelopes can still be correlated by the client."""
    try:
        obj = json.loads(line)
        rid = obj.get("id") if isinstance(obj, dict) else None
        return str(rid) if isinstance(rid, (str, int)) \
            and not isinstance(rid, bool) else None
    except Exception:
        return None


# -- payload (de)serialization ------------------------------------------------

def setting_to_json(setting: DeviceSetting) -> Dict[str, Any]:
    return {"name": setting.name, "dtype": setting.dtype,
            "mode": setting.mode, "device": setting.device}


def setting_from_wire(obj: Any) -> DeviceSetting:
    """A `DeviceSetting` from its wire form: a ``{name,dtype,mode,device}``
    object or a canonical key string (``"device:dtype/mode"``).

    The key string carries everything prediction semantics depend on
    (bank selection + fused-mode rewrite); the synthesized ``name`` is a
    display label only (`setting_key` excludes it).
    """
    if isinstance(obj, DeviceSetting):
        return obj
    if isinstance(obj, dict):
        try:
            return DeviceSetting(
                name=str(obj["name"]), dtype=str(obj.get("dtype", "float32")),
                mode=str(obj.get("mode", "op_by_op")),
                device=str(obj.get("device", "")))
        except (KeyError, TypeError, ValueError) as exc:
            raise RPCError(E_BAD_REQUEST,
                           f"bad setting object: {exc}") from None
    if isinstance(obj, str):
        device, rest = ("", obj)
        if ":" in obj:
            device, rest = obj.split(":", 1)
        parts = rest.split("/")
        if len(parts) != 2 or not all(parts):
            raise RPCError(
                E_BAD_REQUEST,
                f"bad setting key {obj!r} (want 'dtype/mode' or "
                f"'device:dtype/mode')")
        try:
            return DeviceSetting(name=f"wire_{obj}", dtype=parts[0],
                                 mode=parts[1], device=device)
        except ValueError as exc:
            raise RPCError(E_BAD_REQUEST, str(exc)) from None
    raise RPCError(E_BAD_REQUEST,
                   f"setting must be a key string or object, "
                   f"got {type(obj).__name__}")


def graph_from_wire(obj: Any) -> OpGraph:
    """Decode + validate an `OpGraph.to_json` payload."""
    if not isinstance(obj, dict):
        raise RPCError(E_BAD_GRAPH,
                       f"graph must be an OpGraph.to_json object, "
                       f"got {type(obj).__name__}")
    try:
        g = OpGraph.from_json(obj)
        g.validate()
        return g
    except RPCError:
        raise
    except Exception as exc:
        raise RPCError(E_BAD_GRAPH, f"graph failed to decode: {exc}") from None


def report_to_json(report: PredictionReport) -> Dict[str, Any]:
    return report.to_json()


def report_from_json(d: Dict[str, Any]) -> PredictionReport:
    try:
        return PredictionReport.from_json(d)
    except (KeyError, TypeError, ValueError) as exc:
        raise RPCError(E_BAD_REQUEST, f"bad report payload: {exc}") from None


def setting_key_of(obj: Any) -> str:
    """Canonical setting key of any wire form (string passes through
    after a round-trip so malformed keys still fail loudly)."""
    return setting_key(setting_from_wire(obj))


__all__ = [
    "PROTOCOL_VERSION", "METHODS", "RPCError", "Request", "Response",
    "E_BAD_GRAPH", "E_BAD_REQUEST", "E_INTERNAL", "E_OVERLOADED",
    "E_TIMEOUT", "E_UNAVAILABLE", "E_UNKNOWN_METHOD", "E_UNKNOWN_SETTING",
    "E_UNKNOWN_VERSION",
    "decode_request", "decode_response", "encode_request", "encode_response",
    "graph_from_wire", "report_from_json", "report_to_json", "request_id_of",
    "setting_from_wire", "setting_key_of", "setting_to_json",
]
