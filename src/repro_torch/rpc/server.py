"""Threaded JSON-lines RPC server fronting a `LatencyService`.

Transport-agnostic dispatch over line-oriented streams: the TCP
listener (`start`) wraps each accepted socket in the same
`serve_stream` loop that also serves stdio-style file pairs, so tests,
pipes, and sockets all exercise one code path.

Requests on a connection are *pipelined*: the reader thread decodes
each line and dispatches it immediately — ``predict`` submits to the
`MicroBatcher` and attaches a completion callback that writes the
response when the flush resolves it, so many in-flight predicts from
one client coalesce into one `predict_batch` (responses may return
out of order; clients correlate by ``id``).  Cheap methods
(``available``, ``stats``, ``search_front``, and the already-batched
``predict_multi``) are answered inline on the reader thread.

A search front (`repro_torch.search` `SearchReport` or a `SearchEngine`
checkpoint file) can be registered and queried over the same wire —
"which architectures meet budget X on device Y" served from the same
process that predicts latencies.

Port notes (twin of ``repro.rpc.server``): ``rollover`` rebuilds the
shipped bank on the serving hub's ``device`` (a service without a hub is
refused before the payload is read), and the ``tree_gather`` residency
collector is always registered.
"""
from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dataclasses import replace as _dc_replace

from repro_torch.core.composition import PredictorBank
from repro_torch.kernels.tree_gather import residency_counters
from repro_torch.obs import Observability, to_prometheus
from repro_torch.rpc.batcher import BatchPolicy, MicroBatcher, PendingResult
from repro_torch.rpc.protocol import (E_BAD_REQUEST, E_INTERNAL, E_UNAVAILABLE,
                                      E_UNKNOWN_METHOD, E_UNKNOWN_SETTING,
                                      PROTOCOL_VERSION, METHODS, Request, Response,
                                      RPCError, decode_request, encode_response,
                                      graph_from_wire, request_id_of,
                                      setting_from_wire, setting_key_of)
from repro_torch.pipeline.store import setting_key
from repro_torch.utils.logging import get_logger

log = get_logger("repro.rpc.server")


def _front_from_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a search artifact into ``{budgets, members}``.

    Accepts either a `SearchReport.to_json()` payload or a
    `SearchEngine.save()` checkpoint (detected by its ``memo``/
    ``genotypes`` state); both reduce to the served shape: one entry
    per front member with digest, genotype, quality, and per-setting
    predicted latencies.
    """
    if "memo" in state and "genotypes" in state:      # engine checkpoint
        members = []
        for digest, _obj, _payload in state.get("front", {}).get("members", []):
            e = state["memo"].get(digest)
            if e is None:
                continue
            members.append({
                "digest": digest,
                "genotype": state["genotypes"].get(digest),
                "quality": float(e["quality"]),
                "latencies": {k: float(v) for k, v in e["lat"].items()},
            })
        return {"budgets": state.get("budgets", []), "members": members}
    if "front" in state:                               # SearchReport shape
        members = [{
            "digest": m["digest"], "genotype": m["genotype"],
            "quality": float(m["quality"]),
            "latencies": {k: float(v) for k, v in m["latencies"].items()},
        } for m in state["front"]]
        return {"budgets": state.get("budgets", []), "members": members}
    raise ValueError("unrecognized search artifact (expected a SearchReport "
                     "JSON or a SearchEngine checkpoint)")


class LatencyRPCServer:
    """Serves one `LatencyService` over the v1 JSONL protocol."""

    def __init__(self, service: Any, *,
                 policy: Optional[BatchPolicy] = None,
                 clock: Optional[Any] = None,
                 batcher: Optional[MicroBatcher] = None,
                 auto_start_batcher: bool = True,
                 search_report: Any = None,
                 chaos: Optional[Any] = None,
                 obs: Optional[Observability] = None,
                 autopilot: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        # Optional `repro_torch.rpc.chaos.FaultPlan`: consulted per dispatch
        # ("dispatch" site: injected error envelopes / latency spikes)
        # and per response write ("transport" site: dropped
        # connections).  A server-owned batcher shares the same plan
        # for its "flush" site.
        self.chaos = chaos
        # With an explicit obs bundle the server traces dispatches,
        # echoes wire trace contexts, and adds the compact metrics
        # summary to `health`; without one it keeps a quiet private
        # bundle (absent-by-default keeps pre-obs response shapes and
        # golden bytes intact).
        self._obs_explicit = obs is not None
        self.obs = obs or Observability.quiet()
        # Optional `repro_torch.obs.autopilot.RecalibrationAutopilot`: its
        # status rides the `health` response, and the `metrics` RPC
        # serves its timeline + audit log on request.
        self.autopilot = autopilot
        self.batcher = batcher or MicroBatcher(
            service, policy, clock=clock, auto_start=auto_start_batcher,
            chaos=chaos, obs=self.obs)
        self._owns_batcher = batcher is None
        self.host, self.port = host, int(port)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stopped = False
        self.requests = 0
        self.errors = 0
        self.connections = 0
        self._front: Optional[Dict[str, Any]] = None
        if search_report is not None:
            self.register_search_report(search_report)
        self._register_collectors()

    def _register_collectors(self) -> None:
        """Join every component's pre-existing ``stats()`` view into the
        one registry snapshot the `metrics` endpoint serves."""
        reg = self.obs.registry
        if hasattr(self.service, "stats"):
            reg.collect("service", self.service.stats)
        if not self._owns_batcher or self.batcher.obs is not self.obs:
            # External batcher with its own registry: pull its stats.
            reg.collect("batcher", self.batcher.stats)
        if self.chaos is not None and hasattr(self.chaos, "stats"):
            reg.collect("chaos", self.chaos.stats)
        session = getattr(self.service, "session", None)
        if session is not None and hasattr(session, "stats"):
            reg.collect("profiler", session.stats)
        store = getattr(self.service, "store", None)
        if store is not None and hasattr(store, "stats"):
            reg.collect("store", store.stats)
        reg.collect("tree_gather", residency_counters)
        if self.autopilot is not None:
            reg.collect("autopilot", self.autopilot.status)
            reg.collect("alerts", self.autopilot.engine.stats)
            reg.collect("timeline", self.autopilot.engine.timeline.stats)
        reg.collect("server", self._server_stats)

    # -- search-front endpoint ------------------------------------------------
    def register_search_report(self, report: Any) -> None:
        """Serve front queries from a `SearchReport`, its JSON dict, or a
        checkpoint/report file path."""
        if hasattr(report, "to_json"):
            state = report.to_json()
        elif isinstance(report, str):
            with open(report) as f:
                state = json.load(f)
        elif isinstance(report, dict):
            state = report
        else:
            raise TypeError(f"cannot register {type(report).__name__} "
                            f"as a search report")
        self._front = _front_from_state(state)

    # -- dispatch -------------------------------------------------------------
    def dispatch(self, req: Request,
                 respond: Callable[[Response], None]) -> None:
        """Route one decoded request; ``respond`` is called exactly once
        (possibly later, from a batcher flush, for ``predict``).

        A request carrying a ``trace`` context gets a dispatch span
        parented to it, and the response echoes this server's span
        context back (``Response.trace``) — so a traced client can
        stitch the full client→server→flush tree.  Untraced requests
        produce untraced responses, byte-identical to the pre-obs wire.
        """
        span = self.obs.tracer.start_span(
            "rpc.server.dispatch", trace=req.trace,
            attrs={"method": req.method, "id": req.id})
        echo = (self.obs.tracer.wire_context(span)
                if req.trace is not None else None)

        def reply(resp: Response, status: str = "ok") -> None:
            if echo is not None:
                resp = _dc_replace(resp, trace=echo)
            span.end(status)
            respond(resp)

        try:
            if self.chaos is not None:
                fault = self.chaos.decide("dispatch")
                if fault is not None:
                    if fault.kind == "error":
                        self._count_error()
                        self.obs.dump("chaos_fault", site="dispatch",
                                      code=fault.to_error().code,
                                      method=req.method)
                        reply(Response(id=req.id, ok=False,
                                       error=fault.to_error()), "error")
                        return
                    if fault.kind == "delay":
                        time.sleep(fault.delay_s)
            if req.method == "predict":
                # Ambient-activate the dispatch span so the batcher's
                # enqueue/shed events (emitted on this thread inside
                # submit()) parent under it.
                with self.obs.tracer.activate(span):
                    self._predict_async(req, reply)
                return
            handler = {
                "predict_multi": self._predict_multi,
                "available": self._available,
                "stats": self._stats,
                "search_front": self._search_front,
                "health": self._health,
                "rollover": self._rollover,
                "metrics": self._metrics,
            }.get(req.method)
            if handler is None:
                known = ", ".join(METHODS)
                raise RPCError(E_UNKNOWN_METHOD,
                               f"unknown method {req.method!r} "
                               f"(known: {known})", retryable=False)
            reply(Response(id=req.id, ok=True, result=handler(req.params)))
        except RPCError as exc:
            self._count_error()
            reply(Response(id=req.id, ok=False, error=exc), "error")
        except Exception as exc:
            # Every unexpected handler exception leaves as a well-formed
            # typed envelope — a crash mid-handler must never kill the
            # connection or leak a raw traceback onto the wire
            # (tests/test_rpc.py pins this envelope).
            log.exception("request %s failed", req.id)
            self._count_error()
            reply(Response(id=req.id, ok=False,
                           error=RPCError(E_INTERNAL,
                                          f"{type(exc).__name__}: {exc}")),
                  "error")

    def _count_error(self) -> None:
        with self._lock:
            self.errors += 1

    def _predict_async(self, req: Request,
                       respond: Callable[..., None]) -> None:
        params = req.params
        if "graph" not in params:
            raise RPCError(E_BAD_REQUEST, "predict needs params.graph")
        graph = graph_from_wire(params["graph"])
        setting = (setting_from_wire(params["setting"])
                   if params.get("setting") is not None else None)
        predictor = params.get("predictor")
        pending = self.batcher.submit(graph, setting, predictor)
        rid = req.id

        def on_done(p: PendingResult) -> None:
            err = p.error()
            if err is not None:
                self._count_error()
                respond(Response(id=rid, ok=False, error=err), "error")
            else:
                respond(Response(id=rid, ok=True,
                                 result={"report": p.result(0).to_json()}))

        pending.add_done_callback(on_done)

    def _predict_multi(self, params: Dict[str, Any]) -> Dict[str, Any]:
        graphs = params.get("graphs")
        settings = params.get("settings")
        if not isinstance(graphs, list) or not graphs:
            raise RPCError(E_BAD_REQUEST,
                           "predict_multi needs a non-empty params.graphs")
        if not isinstance(settings, list) or not settings:
            raise RPCError(E_BAD_REQUEST,
                           "predict_multi needs a non-empty params.settings")
        gs = [graph_from_wire(g) for g in graphs]
        ss = [setting_from_wire(s) for s in settings]
        try:
            multi = self.service.predict_multi(gs, ss,
                                               params.get("predictor"))
        except KeyError as exc:
            raise RPCError(E_UNKNOWN_SETTING, str(exc),
                           retryable=False) from None
        return {"reports": {k: [r.to_json() for r in v]
                            for k, v in multi.items()}}

    def _available(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {"banks": [list(b) for b in self.service.available()]}

    def _server_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"requests": self.requests, "errors": self.errors,
                    "connections": self.connections,
                    "protocol_version": PROTOCOL_VERSION}

    def _stats(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {"server": self._server_stats(),
                "batcher": self.batcher.stats(),
                "service": self.service.stats()}

    def _metrics(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Full registry snapshot (counters, gauges, histograms, plus
        every collected ``stats()`` view) — the scrape endpoint.

        ``format: "prometheus"`` returns the text exposition instead
        (stamped with a ``repro_scrape_timestamp_seconds`` gauge from
        the server's injectable clock); ``dumps: true`` appends the
        flight recorder's fault dumps; with an autopilot attached,
        ``timeline: true`` adds the metrics timeline ring and
        ``audit: true`` the control-plane audit log.
        """
        fmt = params.get("format", "json")
        if fmt not in ("json", "prometheus"):
            raise RPCError(E_BAD_REQUEST,
                           f"unknown metrics format {fmt!r} "
                           f"(known: json, prometheus)", retryable=False)
        snap = self.obs.registry.snapshot()
        if fmt == "prometheus":
            out: Dict[str, Any] = {"text": to_prometheus(snap,
                                                         now=self.obs.now())}
        else:
            out = {"snapshot": snap}
        if params.get("dumps"):
            out["dumps"] = list(self.obs.recorder.dumps)
        if params.get("timeline") or params.get("audit"):
            if self.autopilot is None:
                raise RPCError(E_UNAVAILABLE,
                               "no autopilot attached — timeline/audit "
                               "queries need one", retryable=False)
            if params.get("timeline"):
                out["timeline"] = self.autopilot.engine.timeline.to_json()
            if params.get("audit"):
                out["audit"] = self.autopilot.audit.events(
                    params.get("audit_kind"))
        return out

    def _health(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Degradation state for load balancers / chaos suites: the
        batcher's shed tier, queue depth, and the hub's bank epochs."""
        tier = self.batcher.shed_tier()
        status = {"accept": "ok", "cache_only": "degraded",
                  "reject": "overloaded"}.get(tier, "degraded")
        hub = getattr(self.service, "hub", None)
        out = {
            "status": status,
            "shed_tier": tier,
            "queued": self.batcher.queued(),
            "queue_capacity": self.batcher.policy.max_queue,
            "hub_epoch": getattr(hub, "epoch", 0),
            "bank_epochs": hub.epochs() if hasattr(hub, "epochs") else {},
            "protocol_version": PROTOCOL_VERSION,
        }
        if self._obs_explicit:
            # Compact live summary for dashboards — only with an
            # explicit obs bundle, so the pre-obs health shape (and its
            # golden bytes) stays untouched by default.
            q = self.batcher.flush_latency_quantiles()
            worst = self.obs.drift.worst_cells(1)
            out["metrics"] = {
                "queued": self.batcher.queued(),
                "flush_p50_s": q["p50"],
                "flush_p99_s": q["p99"],
                "drift_score": self.obs.drift.score(),
                "drift_top": worst[0] if worst else None,
            }
        if self.autopilot is not None:
            out["autopilot"] = self.autopilot.status()
        return out

    def _rollover(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Zero-downtime bank swap: install a wire-shipped bank under
        (setting, family) and return its new epoch.  In-flight flushes
        finish against the bank they snapshot; new admissions see the
        new one."""
        if "setting" not in params or "bank" not in params:
            raise RPCError(E_BAD_REQUEST,
                           "rollover needs params.setting and params.bank")
        setting = setting_from_wire(params["setting"])
        family = params.get("family") or self.service.predictor
        hub = getattr(self.service, "hub", None)
        if hub is None or not hasattr(hub, "swap_bank"):
            raise RPCError(E_UNAVAILABLE,
                           "service exposes no hub to roll over",
                           retryable=False)
        try:
            # Rebuilt on the serving hub's device: device-bound families
            # (lasso, MLP) land where the hub serves them.
            bank = PredictorBank.from_json(params["bank"], device=hub.device)
        except Exception as exc:
            raise RPCError(E_BAD_REQUEST,
                           f"bad bank payload: {exc}") from None
        epoch = hub.swap_bank(setting, family, bank)
        return {"setting": setting_key(setting), "family": family,
                "epoch": int(epoch)}

    def _search_front(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if self._front is None:
            raise RPCError(E_UNAVAILABLE, "no search report registered "
                           "on this server")
        members = self._front["members"]
        skey = None
        if params.get("setting") is not None:
            skey = setting_key_of(params["setting"])
        elif self._front["budgets"]:
            b = self._front["budgets"][0]["setting"]
            skey = setting_key(setting_from_wire(b))
        elif members:
            skey = sorted(members[0]["latencies"])[0]
        if skey is None:
            raise RPCError(E_UNAVAILABLE, "search front is empty")
        if members and not any(skey in m["latencies"] for m in members):
            known = sorted({k for m in members for k in m["latencies"]})
            raise RPCError(E_UNKNOWN_SETTING,
                           f"setting {skey!r} was not among the searched "
                           f"devices {known}", retryable=False)
        budget_s = params.get("budget_s")
        if budget_s is not None and not isinstance(budget_s, (int, float)):
            raise RPCError(E_BAD_REQUEST, "budget_s must be a number")
        hits = [m for m in members
                if skey in m["latencies"]
                and (budget_s is None or m["latencies"][skey] <= budget_s)]
        hits.sort(key=lambda m: (-m["quality"], m["digest"]))
        limit = params.get("limit")
        total = len(hits)
        if limit is not None:
            if not isinstance(limit, int) or limit < 0:
                raise RPCError(E_BAD_REQUEST,
                               "limit must be a non-negative integer")
            hits = hits[:limit]
        return {"setting": skey, "total": total, "members": hits}

    # -- line/stream transports ----------------------------------------------
    def handle_line(self, line: str,
                    respond: Optional[Callable[[str], None]] = None,
                    timeout: Optional[float] = 30.0) -> Optional[str]:
        """Process one request line.

        With ``respond`` (pipelined transports), the encoded response
        line is delivered through it — possibly from another thread —
        and None is returned.  Without it, blocks up to ``timeout`` and
        returns the encoded response line (the simple sync entry point).
        """
        with self._lock:
            self.requests += 1
        try:
            req = decode_request(line)
        except RPCError as exc:
            self._count_error()
            out = encode_response(
                Response(id=request_id_of(line), ok=False, error=exc))
            if respond is not None:
                respond(out)
                return None
            return out
        if respond is not None:
            self.dispatch(req, lambda r: respond(encode_response(r)))
            return None
        done = threading.Event()
        slot: List[Response] = []

        def collect(r: Response) -> None:
            slot.append(r)
            done.set()

        self.dispatch(req, collect)
        if not done.wait(timeout):
            self._count_error()
            return encode_response(Response(
                id=req.id, ok=False,
                error=RPCError(E_UNAVAILABLE,
                               f"no response within {timeout}s")))
        return encode_response(slot[0])

    def serve_stream(self, rfile: Any, wfile: Any,
                     drain_timeout: float = 10.0,
                     conn: Optional[socket.socket] = None) -> None:
        """Serve a line-oriented stream pair until EOF (stdio mode, and
        the per-connection loop of the TCP listener).

        Responses are written by a dedicated per-connection writer
        thread fed through a bounded non-blocking queue, so a slow or
        stalled peer can never block the batcher's flush worker (which
        delivers predict responses through `respond`) — a peer that
        stops reading fills its queue and gets dropped instead of
        head-of-line-blocking every other connection.  On EOF, in-flight
        requests get ``drain_timeout`` to settle before the writer is
        torn down.
        """
        out_q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=4096)
        dead = threading.Event()            # peer unusable: drop output
        olock = threading.Lock()
        idle = threading.Condition(olock)
        outstanding = [0]

        def writer() -> None:
            while True:
                line = out_q.get()
                if line is None:
                    return
                data = line + "\n"
                try:
                    try:
                        wfile.write(data)
                    except TypeError:          # binary stream wants bytes
                        wfile.write(data.encode())
                    wfile.flush()
                except (OSError, ValueError):
                    dead.set()          # keep consuming; writes become drops

        wt = threading.Thread(target=writer, name="rpc-writer", daemon=True)
        wt.start()

        def respond(line: str) -> None:
            with olock:
                outstanding[0] -= 1
                idle.notify_all()
            if dead.is_set():
                return
            if self.chaos is not None:
                fault = self.chaos.decide("transport")
                if fault is not None:
                    if fault.kind == "drop":
                        # Injected connection loss: stop writing and
                        # sever the peer so its reader sees EOF — the
                        # client must reconnect and re-send.
                        dead.set()
                        if conn is not None:
                            try:
                                conn.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                        return
                    if fault.kind == "delay":
                        time.sleep(fault.delay_s)
            try:
                out_q.put_nowait(line)
            except queue.Full:          # stalled peer: drop, don't block
                dead.set()

        try:
            for raw in rfile:
                line = raw.decode() if isinstance(raw, bytes) else raw
                if not line.strip():
                    continue
                with olock:
                    outstanding[0] += 1
                self.handle_line(line, respond=respond)
        finally:
            with idle:
                idle.wait_for(lambda: outstanding[0] <= 0,
                              timeout=drain_timeout)
            try:
                out_q.put(None, timeout=drain_timeout)
            except queue.Full:          # writer stuck on a dead socket
                pass
            wt.join(timeout=drain_timeout)

    # -- TCP listener ---------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Bind + listen + accept in the background; returns (host, port)."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(64)
        self.port = sock.getsockname()[1]
        self._sock = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
        self._accept_thread.start()
        log.info("latency RPC server listening on %s:%d", self.host, self.port)
        return self.host, self.port

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stopped:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                                 # listener closed
            if self._stopped:
                # Raced with stop(): the blocked accept() syscall keeps
                # the kernel socket alive past close(), so one last
                # connection can slip through — refuse it.
                try:
                    conn.close()
                except OSError:
                    pass
                return
            with self._lock:
                self.connections += 1
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rpc-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            rfile = conn.makefile("rb")
            wfile = conn.makefile("wb")
            self.serve_stream(rfile, wfile, conn=conn)
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def stop(self) -> None:
        """Close the listener and every connection; drain the batcher."""
        self._stopped = True
        if self._sock is not None:
            try:
                # shutdown() (not just close()) wakes a thread blocked
                # in accept(): close() alone leaves the kernel socket
                # listening while the syscall holds its last reference.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._owns_batcher:
            self.batcher.close()

    def __enter__(self) -> "LatencyRPCServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["LatencyRPCServer"]
