"""Pipelined JSON-lines client for the latency RPC server.

One TCP connection, many in-flight requests: `send`s are cheap
(id-tagged lines behind a write lock) and a single reader thread
routes each response line to its waiting caller by id — so N client
threads calling `predict` concurrently, or one thread calling
`predict_pipelined`, land together in the server's micro-batcher and
come back as one `predict_batch`.

Fault tolerance: losing the connection no longer bricks the client.
In-flight requests fail with a *retryable* ``unavailable`` envelope,
and the next `send` transparently reconnects (``reconnect=True``).
Connections are generation-counted so a dying reader thread can only
fail requests that were actually sent on its own connection — never
ones already re-sent on the replacement.  Pass a
`repro_torch.rpc.resilience.RetryPolicy` (and optionally a `CircuitBreaker`)
to make `call` retry retryable envelopes with deterministic, seeded
backoff; `sleep`/`clock` are injectable so tests assert the exact
schedule without wall-clock sleeps.

`predict_e2e` mirrors `LatencyService.predict_e2e`'s signature and
returns real `PredictionReport`s, so the client drops into anything
built against the service — `ServeEngine(latency_service=client, ...)`
gets its decode-step estimate over the wire unchanged.
"""
from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.ir import OpGraph
from repro_torch.core.profiler import DeviceSetting
from repro_torch.obs import Observability
from repro_torch.pipeline.service import PredictionReport
from repro_torch.rpc.protocol import (E_TIMEOUT, E_UNAVAILABLE, Request, Response,
                                      RPCError, decode_response, encode_request,
                                      report_from_json, setting_to_json)
from repro_torch.rpc.resilience import CircuitBreaker, RetryPolicy, retry_call
from repro_torch.utils.logging import get_logger

log = get_logger("repro.rpc.client")


class _Slot:
    __slots__ = ("event", "response", "gen")

    def __init__(self, gen: int = 0) -> None:
        self.event = threading.Event()
        self.response: Optional[Response] = None
        self.gen = gen


class LatencyClient:
    """Thread-safe, reconnecting RPC client (see module docstring)."""

    def __init__(self, host: str, port: int, *,
                 timeout: float = 30.0, connect_timeout: float = 5.0,
                 reconnect: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[Observability] = None):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self.reconnect = bool(reconnect)
        self.retry = retry
        self.breaker = breaker
        self._sleep = sleep
        self._clock = clock
        self._wlock = threading.Lock()
        self._pending: Dict[str, _Slot] = {}
        self._plock = threading.Lock()
        self._ids = itertools.count(1)
        self._closed = False
        # Counters in the obs registry; with a *shared* bundle and a
        # tracing-enabled tracer, every `send` opens a span whose
        # context rides the request's optional ``trace`` field.
        self.obs = obs or Observability.quiet()
        self._cid = self.obs.instance("client")
        for name in ("rpc_client_requests_total",
                     "rpc_client_reconnects_total",
                     "rpc_client_retries_total",
                     "rpc_client_timeouts_total"):
            self.obs.registry.counter(name)
        # Connection state — all guarded by _conn_lock.  _gen counts
        # connections; a reader thread belongs to exactly one gen.
        self._conn_lock = threading.Lock()
        self._gen = 0
        self._connected = False
        self._sock: Optional[socket.socket] = None
        self._rfile: Any = None
        self._wfile: Any = None
        with self._conn_lock:
            self._connect_locked()     # first connect raises OSError loudly

    # -- connection lifecycle --------------------------------------------------
    def _connect_locked(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        if sock.getsockname() == sock.getpeername():
            # TCP simultaneous-open self-connection: connecting to a
            # dead port in the ephemeral range can land on *our own*
            # ephemeral port — the "server" would be us echoing
            # requests back.  Treat it as connection-refused.
            sock.close()
            raise OSError("self-connection detected (server is gone)")
        sock.settimeout(None)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wfile = sock.makefile("wb")
        self._gen += 1
        self._connected = True
        threading.Thread(target=self._read_loop,
                         args=(self._gen, self._rfile),
                         name=f"rpc-client-reader-{self._gen}",
                         daemon=True).start()

    def _teardown_locked(self) -> None:
        # Order is load-bearing: shut the raw socket down FIRST so a
        # reader thread blocked in readline() wakes with EOF — closing
        # a buffered file wrapper from this thread would block on the
        # buffer's internal lock until that read returns.
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for f in (self._wfile, self._rfile):
            try:
                if f is not None:
                    f.close()
            except Exception:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._connected = False

    def _ensure_connected(self) -> None:
        """Reconnect-on-send: a lost connection heals lazily here."""
        with self._conn_lock:
            if self._closed:
                raise RPCError(E_UNAVAILABLE, "client is closed",
                               retryable=False)
            if self._connected:
                return
            if not self.reconnect:
                raise RPCError(E_UNAVAILABLE,
                               "connection lost and reconnect is disabled",
                               retryable=False)
            self._teardown_locked()
            try:
                self._connect_locked()
            except OSError as exc:
                raise RPCError(
                    E_UNAVAILABLE,
                    f"reconnect to {self.host}:{self.port} failed: "
                    f"{exc}") from None
            self.obs.registry.inc("rpc_client_reconnects_total",
                                  client=self._cid)
            self.obs.tracer.event("rpc.client.reconnect",
                                  attrs={"gen": self._gen})
            log.info("reconnected to %s:%d (gen %d)",
                     self.host, self.port, self._gen)

    # -- plumbing -------------------------------------------------------------
    def _read_loop(self, gen: int, rfile: Any) -> None:
        try:
            for raw in rfile:
                line = raw.decode().strip()
                if not line:
                    continue
                try:
                    resp = decode_response(line)
                except RPCError:
                    log.warning("undecodable response line dropped: %.120s",
                                line)
                    continue
                if resp.id is None:
                    continue
                with self._plock:
                    slot = self._pending.get(resp.id)
                    if slot is not None and slot.gen == gen:
                        del self._pending[resp.id]
                    else:
                        slot = None
                if slot is not None:
                    slot.response = resp
                    slot.event.set()
        except (OSError, ValueError):
            pass
        finally:
            # This connection is unusable.  Mark it down (only if no
            # newer connection superseded it) and fail what was in
            # flight *on this generation* — retryable, so callers under
            # a RetryPolicy re-send over the reconnected socket.
            with self._conn_lock:
                if gen == self._gen:
                    self._connected = False
            if self._closed:
                err = RPCError(E_UNAVAILABLE, "client is closed",
                               retryable=False)
            else:
                err = RPCError(E_UNAVAILABLE,
                               "connection lost (reconnects on next send)")
            self._fail_gen(gen, err)

    def _fail_gen(self, gen: int, err: RPCError) -> None:
        """Fail every pending request sent on connection ``gen``."""
        with self._plock:
            dead = [rid for rid, s in self._pending.items() if s.gen == gen]
            slots = [self._pending.pop(rid) for rid in dead]
        for slot in slots:
            slot.response = Response(id=None, ok=False, error=err)
            slot.event.set()

    def send(self, method: str, params: Optional[Dict[str, Any]] = None
             ) -> _Slot:
        """Fire one request; returns the slot to `wait` on (pipelining).

        Reconnects first if the previous connection died; raises a
        retryable ``unavailable`` if the server cannot be reached."""
        if self._closed:
            raise RPCError(E_UNAVAILABLE, "client is closed", retryable=False)
        self._ensure_connected()
        with self._conn_lock:
            gen, wfile = self._gen, self._wfile
        rid = f"c{next(self._ids)}"
        slot = _Slot(gen)
        with self._plock:
            self._pending[rid] = slot
        self.obs.registry.inc("rpc_client_requests_total",
                              client=self._cid, method=method)
        span = self.obs.tracer.start_span(
            "rpc.client.send", attrs={"method": method, "id": rid})
        line = encode_request(Request(id=rid, method=method,
                                      params=params or {},
                                      trace=self.obs.tracer.wire_context(span)))
        try:
            with self._wlock:
                wfile.write((line + "\n").encode())
                wfile.flush()
        except (OSError, ValueError):
            with self._plock:
                self._pending.pop(rid, None)
            with self._conn_lock:
                if gen == self._gen:
                    self._connected = False
            span.end("error")
            raise RPCError(E_UNAVAILABLE,
                           "connection lost during send") from None
        span.end()
        return slot

    def wait(self, slot: _Slot,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block for a slot's result payload; raises the typed error the
        server sent (or ``timeout``)."""
        if not slot.event.wait(self.timeout if timeout is None else timeout):
            self.obs.registry.inc("rpc_client_timeouts_total",
                                  client=self._cid)
            self.obs.dump("deadline_timeout",
                          timeout_s=self.timeout if timeout is None
                          else timeout)
            raise RPCError(E_TIMEOUT, "no response from server")
        resp = slot.response
        assert resp is not None
        if not resp.ok:
            raise resp.error if resp.error is not None else \
                RPCError(E_UNAVAILABLE, "empty error envelope")
        return resp.result or {}

    def call(self, method: str, params: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """One request/response.  With a client-level `RetryPolicy`
        (``retry=`` at construction) retryable failures are retried with
        seeded backoff; without one, semantics are single-shot."""
        if self.retry is not None:
            return self.call_with_retry(method, params,
                                        policy=self.retry, timeout=timeout)
        return self.wait(self.send(method, params), timeout)

    def call_with_retry(self, method: str,
                        params: Optional[Dict[str, Any]] = None, *,
                        policy: Optional[RetryPolicy] = None,
                        timeout: Optional[float] = None) -> Dict[str, Any]:
        """`call` under `retry_call`: re-send (idempotently, with a
        fresh request id over whatever connection is healthy) on every
        retryable envelope, sleeping the policy's deterministic backoff
        schedule between attempts, within one shared deadline budget."""
        pol = policy or self.retry or RetryPolicy()

        def attempt(budget_s: float) -> Dict[str, Any]:
            t = budget_s if timeout is None else min(timeout, budget_s)
            return self.wait(self.send(method, params), t)

        def note(attempt_no: int, err: RPCError, delay: float) -> None:
            self.obs.registry.inc("rpc_client_retries_total",
                                  client=self._cid)
            self.obs.tracer.event("rpc.client.retry",
                                  attrs={"method": method,
                                         "attempt": attempt_no,
                                         "code": err.code, "delay": delay})

        return retry_call(attempt, pol, sleep=self._sleep, clock=self._clock,
                          breaker=self.breaker, on_retry=note)

    # Registry-backed views of the original counter attributes.
    @property
    def reconnects(self) -> int:
        return int(self.obs.registry.get("rpc_client_reconnects_total",
                                         client=self._cid))

    @property
    def retries(self) -> int:
        return int(self.obs.registry.get("rpc_client_retries_total",
                                         client=self._cid))

    # -- the service-shaped API ----------------------------------------------
    @staticmethod
    def _predict_params(graph: OpGraph,
                        setting: Optional[DeviceSetting],
                        predictor: Optional[str]) -> Dict[str, Any]:
        params: Dict[str, Any] = {"graph": graph.to_json()}
        if setting is not None:
            params["setting"] = setting_to_json(setting)
        if predictor is not None:
            params["predictor"] = predictor
        return params

    def predict_e2e(self, graph: OpGraph,
                    setting: Optional[DeviceSetting] = None,
                    predictor: Optional[str] = None) -> PredictionReport:
        """One graph's predicted end-to-end latency, over the wire."""
        result = self.call("predict",
                           self._predict_params(graph, setting, predictor))
        return report_from_json(result["report"])

    predict = predict_e2e

    def predict_pipelined(self, graphs: Sequence[OpGraph],
                          setting: Optional[DeviceSetting] = None,
                          predictor: Optional[str] = None
                          ) -> List[PredictionReport]:
        """Fire one ``predict`` per graph without waiting between sends,
        then collect — from the server's viewpoint these arrive together
        and coalesce into micro-batches."""
        slots = [self.send("predict",
                           self._predict_params(g, setting, predictor))
                 for g in graphs]
        return [report_from_json(self.wait(s)["report"]) for s in slots]

    def predict_multi(self, graphs: Sequence[OpGraph],
                      settings: Sequence[DeviceSetting],
                      predictor: Optional[str] = None
                      ) -> Dict[str, List[PredictionReport]]:
        """Mirror of `LatencyService.predict_multi` as ONE request (the
        payload is already a batch; it bypasses the micro-batcher)."""
        params: Dict[str, Any] = {
            "graphs": [g.to_json() for g in graphs],
            "settings": [setting_to_json(s) for s in settings],
        }
        if predictor is not None:
            params["predictor"] = predictor
        result = self.call("predict_multi", params)
        return {k: [report_from_json(r) for r in v]
                for k, v in result["reports"].items()}

    def available(self) -> List[List[str]]:
        return self.call("available")["banks"]

    def stats(self) -> Dict[str, Any]:
        return self.call("stats")

    def health(self) -> Dict[str, Any]:
        """Server degradation state: shed tier, queue depth, bank epochs."""
        return self.call("health")

    def metrics(self, *, format: Optional[str] = None,
                dumps: bool = False, timeline: bool = False,
                audit: bool = False,
                audit_kind: Optional[str] = None) -> Dict[str, Any]:
        """The server's full observability snapshot (``format="prometheus"``
        for text exposition; ``dumps=True`` includes flight-recorder
        fault dumps; ``timeline=True``/``audit=True`` add the metrics
        timeline ring and control-plane audit log of a server-side
        autopilot, ``audit_kind`` filtering to one event kind)."""
        params: Dict[str, Any] = {}
        if format is not None:
            params["format"] = format
        if dumps:
            params["dumps"] = True
        if timeline:
            params["timeline"] = True
        if audit:
            params["audit"] = True
        if audit_kind is not None:
            params["audit"] = True
            params["audit_kind"] = audit_kind
        return self.call("metrics", params)

    def rollover(self, setting: Any, bank: Any,
                 family: Optional[str] = None) -> Dict[str, Any]:
        """Zero-downtime bank swap on the server; returns the new epoch.
        ``bank`` is a `PredictorBank` (or its `to_json` payload)."""
        params: Dict[str, Any] = {
            "setting": (setting_to_json(setting)
                        if isinstance(setting, DeviceSetting) else setting),
            "bank": bank.to_json() if hasattr(bank, "to_json") else bank,
        }
        if family is not None:
            params["family"] = family
        return self.call("rollover", params)

    def search_front(self, *, setting: Any = None,
                     budget_s: Optional[float] = None,
                     limit: Optional[int] = None) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        if setting is not None:
            params["setting"] = (setting_to_json(setting)
                                 if isinstance(setting, DeviceSetting)
                                 else setting)
        if budget_s is not None:
            params["budget_s"] = float(budget_s)
        if limit is not None:
            params["limit"] = int(limit)
        return self.call("search_front", params)

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        with self._conn_lock:
            self._teardown_locked()

    def __enter__(self) -> "LatencyClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["LatencyClient"]
