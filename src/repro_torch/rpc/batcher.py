"""Deterministic micro-batching queue in front of `LatencyService`.

Many concurrent single-graph ``predict`` requests are worth little
individually — each costs a full `predict_batch([g])` (per-op-type
predictor dispatch, report assembly) — but coalesced they hit the
batched fast path: ONE `predict_batch` per flush per (setting,
predictor family) group.  On the card a flush of any size runs the
``cuda`` tier: under ``auto``, `AUTO_DEVICE_MIN_SLOTS` is 0
(`repro_torch.core.predictors.flat`), so a GBDT bank answers with one
fused tree-kernel launch per op type of the flush.

Coalescing policy (`BatchPolicy`):

  * a group flushes when it holds ``max_batch`` requests, or when its
    oldest request has waited ``max_wait_ticks`` clock ticks;
  * admission control bounds total queued requests at ``max_queue`` —
    beyond it, submits fail fast with a retryable ``overloaded`` error
    instead of growing an unbounded backlog;
  * requests whose report is already in the service's LRU are answered
    at submit time (cache short-circuit) and never consume queue space;
  * fairness across device settings: each flush round serves every due
    group oldest-waiting-first, at most one ``max_batch`` batch per
    group per round, so one hot device cannot starve the others.

Time is injectable.  `MonotonicClock` (production) maps ticks onto
wall-clock milliseconds; `ManualClock` (tests) only moves when
`advance()` is called, so the flush schedule is a pure function of the
arrival order and the tick sequence — the property suite replays
arbitrary interleavings without ever sleeping (tests/test_rpc_properties.py).

Exactly-once: every submitted request is resolved exactly once (result
or typed error); a double resolve raises instead of silently
overwriting, so lost/duplicated responses fail loudly in tests.

Port notes (twin of ``repro.rpc.batcher``): with ``auto_start`` the
flush — and with it every kernel launch of `predict_batch` — runs on the
batcher's daemon thread, on that thread's current CUDA stream.  A launch
that fails raises there like any other error of `predict_batch`, and the
flush fails its whole batch with a typed ``internal`` envelope.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.ir import OpGraph
from repro_torch.core.profiler import DeviceSetting
from repro_torch.obs import DEFAULT_SIZE_BUCKETS, Observability
from repro_torch.pipeline.service import PredictionReport
from repro_torch.pipeline.store import setting_key
from repro_torch.rpc.protocol import (E_INTERNAL, E_OVERLOADED, E_TIMEOUT,
                                      E_UNAVAILABLE, E_UNKNOWN_SETTING, RPCError)
from repro_torch.utils.logging import get_logger

log = get_logger("repro.rpc.batcher")


# -- clocks -------------------------------------------------------------------

class MonotonicClock:
    """Wall-clock ticks (default 1 tick = 1 ms) for production serving."""

    def __init__(self, tick_s: float = 1e-3):
        self.tick_s = float(tick_s)
        self._t0 = time.monotonic()

    def now(self) -> int:
        return int((time.monotonic() - self._t0) / self.tick_s)

    def wait(self, cond: threading.Condition, ticks: Optional[int]) -> None:
        """Block on ``cond`` for at most ``ticks`` (None = indefinitely)."""
        cond.wait(None if ticks is None else max(ticks, 1) * self.tick_s)


class ManualClock:
    """Discrete injectable clock — time moves only via `advance()`.

    Waiters (the batcher's flush worker) subscribe a wake callback, so
    advancing the clock from a test thread re-evaluates deadlines
    immediately; nothing in the system sleeps on wall time.
    """

    def __init__(self, start: int = 0):
        self._now = int(start)
        self._lock = threading.Lock()
        self._listeners: List[Callable[[], None]] = []

    def now(self) -> int:
        with self._lock:
            return self._now

    def advance(self, ticks: int = 1) -> int:
        with self._lock:
            self._now += int(ticks)
            now = self._now
            listeners = list(self._listeners)
        for fn in listeners:
            fn()
        return now

    def subscribe(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def wait(self, cond: threading.Condition, ticks: Optional[int]) -> None:
        # Manual time never elapses on its own; wake-ups come from
        # `advance()`/submit notifications.  The bounded real-time wait
        # is a liveness backstop, not a schedule.
        cond.wait(0.1)


# -- request futures ----------------------------------------------------------

class PendingResult:
    """A one-shot future for a submitted request.

    Resolution is exactly-once by construction: a second `_resolve` or
    `_fail` raises `RuntimeError` — the concurrency suite leans on this
    to detect duplicated responses rather than masking them.
    """

    __slots__ = ("_event", "_lock", "_report", "_error", "_callbacks",
                 "_obs")

    def __init__(self, obs: Optional[Any] = None) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._report: Optional[PredictionReport] = None
        self._error: Optional[RPCError] = None
        self._callbacks: List[Callable[["PendingResult"], None]] = []
        self._obs = obs            # flight-recorder dumps on deadline misses

    def done(self) -> bool:
        return self._event.is_set()

    def _settle(self, report: Optional[PredictionReport],
                error: Optional[RPCError]) -> None:
        with self._lock:
            if self._event.is_set():
                raise RuntimeError("PendingResult resolved twice")
            self._report, self._error = report, error
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:                      # pragma: no cover
                log.exception("PendingResult callback failed")

    def _resolve(self, report: PredictionReport) -> None:
        self._settle(report, None)

    def _fail(self, error: RPCError) -> None:
        self._settle(None, error)

    def add_done_callback(self, fn: Callable[["PendingResult"], None]) -> None:
        """Run ``fn(self)`` once settled (immediately if already done)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def error(self) -> Optional[RPCError]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> PredictionReport:
        """The report (blocking); raises the request's `RPCError` on
        failure or a retryable ``timeout`` error if not settled in time."""
        if not self._event.wait(timeout):
            if self._obs is not None:
                self._obs.dump("deadline_timeout", timeout_s=timeout)
            raise RPCError(E_TIMEOUT,
                           f"request not answered within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._report is not None
        return self._report


@dataclass(frozen=True)
class BatchPolicy:
    """Flush/admission knobs (see module docstring).

    Tiered load shedding: below ``shed_frac * max_queue`` queued
    requests everything is admitted (tier ``accept``).  At or above the
    watermark, fresh work is shed with a retryable ``overloaded`` while
    report-cache hits are still answered (tier ``cache_only`` — they
    cost no queue space).  If, while shed, the oldest queued request is
    overdue by more than ``shed_reject_ticks`` past its flush deadline
    — the queue is not just full but *stuck* — even cache lookups are
    skipped and every submit is rejected outright (tier ``reject``).
    Defaults (``shed_frac=1.0``, ``shed_reject_ticks=None``) reproduce
    the original single-cliff behavior exactly.
    """

    max_batch: int = 32        # flush a group at this many requests
    max_wait_ticks: int = 2    # ... or when its oldest waited this long
    max_queue: int = 1024      # total queued requests before admission fails
    shed_frac: float = 1.0     # queue-fill watermark for the cache_only tier
    shed_reject_ticks: Optional[int] = None   # head-of-line overdue-age
    #                            escalation to the reject tier (None = never)

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ticks < 0:
            raise ValueError("max_wait_ticks must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not 0.0 < self.shed_frac <= 1.0:
            raise ValueError("shed_frac must be in (0, 1]")
        if self.shed_reject_ticks is not None and self.shed_reject_ticks < 0:
            raise ValueError("shed_reject_ticks must be >= 0")


@dataclass
class _Entry:
    seq: int
    graph: OpGraph
    setting: DeviceSetting
    family: str
    deadline: int
    pending: PendingResult


class MicroBatcher:
    """Coalesces concurrent single-graph requests into batched predicts.

    ``auto_start=True`` (default) runs a daemon flush worker; with
    ``auto_start=False`` the owner drives flushing explicitly via
    `run_pending()` / `flush_all()` — the deterministic test mode.
    """

    def __init__(self, service: Any, policy: Optional[BatchPolicy] = None, *,
                 clock: Optional[Any] = None, auto_start: bool = True,
                 chaos: Optional[Any] = None,
                 obs: Optional[Observability] = None):
        self.service = service
        self.policy = policy or BatchPolicy()
        self.clock = clock or MonotonicClock()
        # Optional `repro_torch.rpc.chaos.FaultPlan` — consulted once per
        # flush ("flush" site) to inject batch-wide errors, delays, and
        # wedges for the fault-tolerance suite.
        self.chaos = chaos
        self._cond = threading.Condition()
        # (setting key, family) → FIFO of entries awaiting a flush.
        self._groups: "OrderedDict[Tuple[str, str], Deque[_Entry]]" = OrderedDict()
        self._seq = 0
        self._queued = 0
        self._closed = False
        # All counters live in the obs registry (shared with the server
        # and any other component handed the same bundle — the `metrics`
        # RPC endpoint's single-snapshot accounting depends on that).
        # `stats()` stays the same dict it always was, as a view.
        self.obs = obs or Observability.quiet()
        self._mid = self.obs.instance("batcher")
        reg = self.obs.registry
        for name in ("submitted", "answered", "failed", "rejected",
                     "shed_cache_only", "shed_rejected", "wedged_flushes",
                     "short_circuits", "batches", "batched_requests"):
            reg.counter(f"rpc_batcher_{name}_total")
        reg.counter("rpc_flush_backend_total")
        reg.gauge("rpc_batcher_queue_depth")
        reg.gauge("rpc_batcher_max_batch")
        reg.histogram("rpc_batcher_flush_batch_size",
                      buckets=DEFAULT_SIZE_BUCKETS)
        reg.histogram("rpc_batcher_flush_duration")
        reg.set("rpc_batcher_queue_depth", 0, batcher=self._mid)
        if hasattr(self.clock, "subscribe"):
            self.clock.subscribe(self._wake)
        self._worker: Optional[threading.Thread] = None
        if auto_start:
            self._worker = threading.Thread(
                target=self._run, name="rpc-batcher", daemon=True)
            self._worker.start()

    # -- metrics plumbing -----------------------------------------------------
    def _inc(self, name: str, value: int = 1, **labels: Any) -> None:
        self.obs.registry.inc(f"rpc_batcher_{name}_total", value,
                              batcher=self._mid, **labels)

    def _cnt(self, name: str) -> int:
        return int(self.obs.registry.get(f"rpc_batcher_{name}_total",
                                         batcher=self._mid))

    def _set_depth_locked(self) -> None:
        self.obs.registry.set("rpc_batcher_queue_depth", self._queued,
                              batcher=self._mid)

    def flush_latency_quantiles(self) -> Dict[str, float]:
        """p50/p99 of flush durations (in the obs clock's units) — the
        `health` endpoint's compact latency summary."""
        reg = self.obs.registry
        return {"p50": reg.hist_quantile("rpc_batcher_flush_duration", 0.5,
                                         batcher=self._mid),
                "p99": reg.hist_quantile("rpc_batcher_flush_duration", 0.99,
                                         batcher=self._mid)}

    # -- submission -----------------------------------------------------------
    def _shed_tier_locked(self, now: int) -> str:
        """Current degradation tier (caller holds ``_cond``)."""
        if self._queued < self.policy.max_queue * self.policy.shed_frac:
            return "accept"
        if self.policy.shed_reject_ticks is not None:
            heads = [q[0].deadline for q in self._groups.values() if q]
            if heads and now - min(heads) > self.policy.shed_reject_ticks:
                return "reject"        # shed AND the queue is stuck
        return "cache_only"

    def shed_tier(self) -> str:
        with self._cond:
            return self._shed_tier_locked(self.clock.now())

    def submit(self, graph: OpGraph,
               setting: Optional[DeviceSetting] = None,
               predictor: Optional[str] = None) -> PendingResult:
        """Enqueue one request; returns its future.

        Raises `RPCError` synchronously for admission failures
        (``overloaded``, per the shedding tiers of `BatchPolicy`),
        unknown settings, or a closed batcher — the request was never
        accepted, so there is nothing to await.
        """
        setting = setting or getattr(self.service, "default_setting", None)
        if setting is None:
            raise RPCError(E_UNKNOWN_SETTING,
                           "no device setting given and the service has "
                           "no default", retryable=False)
        family = predictor or self.service.predictor
        with self._cond:
            if self._closed:
                raise RPCError(E_UNAVAILABLE, "batcher is closed")
            tier = self._shed_tier_locked(self.clock.now())
            if tier == "reject":
                # Deep overload with a stalled queue: reject before even
                # touching the report cache — the cheapest possible "no".
                self._inc("rejected")
                self._inc("shed_rejected")
                self.obs.tracer.event("rpc.batcher.shed",
                                      attrs={"tier": tier,
                                             "queued": self._queued})
                raise RPCError(
                    E_OVERLOADED,
                    f"shedding all work (tier reject: {self._queued}/"
                    f"{self.policy.max_queue} queued and head-of-line "
                    f"stalled)")
        # Cache short-circuit: answered before admission, so repeats of
        # a hot graph neither queue nor count against max_queue.
        hit = self.service.cache_peek(graph, setting, family)
        if hit is not None:
            pending = PendingResult(self.obs)
            with self._cond:
                if self._closed:
                    raise RPCError(E_UNAVAILABLE, "batcher is closed")
                self._inc("submitted")
                self._inc("short_circuits")
                self._inc("answered")
            pending._resolve(hit)
            return pending
        key = (setting_key(setting), family)
        with self._cond:
            if self._closed:
                raise RPCError(E_UNAVAILABLE, "batcher is closed")
            tier = self._shed_tier_locked(self.clock.now())
            if tier != "accept":
                self._inc("rejected")
                self._inc("shed_cache_only")
                self.obs.tracer.event("rpc.batcher.shed",
                                      attrs={"tier": tier,
                                             "queued": self._queued})
                raise RPCError(
                    E_OVERLOADED,
                    f"shedding fresh work (tier {tier}: {self._queued}/"
                    f"{self.policy.max_queue} requests pending; cached "
                    f"graphs still served)")
            if self._queued >= self.policy.max_queue:   # hard backstop
                self._inc("rejected")
                raise RPCError(
                    E_OVERLOADED,
                    f"queue full ({self._queued}/{self.policy.max_queue} "
                    f"requests pending)")
            self._seq += 1
            entry = _Entry(
                seq=self._seq, graph=graph, setting=setting, family=family,
                deadline=self.clock.now() + self.policy.max_wait_ticks,
                pending=PendingResult(self.obs))
            self._groups.setdefault(key, deque()).append(entry)
            self._queued += 1
            self._inc("submitted")
            self._set_depth_locked()
            self.obs.tracer.event("rpc.batcher.enqueue",
                                  attrs={"group": f"{key[0]}/{key[1]}",
                                         "seq": entry.seq,
                                         "queued": self._queued})
            self._cond.notify_all()
        return entry.pending

    # -- flushing -------------------------------------------------------------
    def _due_keys(self, now: int, force: bool) -> List[Tuple[str, str]]:
        """Due groups, oldest-waiting first (deterministic fairness)."""
        due = [(q[0].seq, k) for k, q in self._groups.items()
               if q and (force or len(q) >= self.policy.max_batch
                         or q[0].deadline <= now)]
        due.sort()
        return [k for _, k in due]

    def _take_batch(self, key: Tuple[str, str]) -> List[_Entry]:
        q = self._groups.get(key)
        batch: List[_Entry] = []
        while q and len(batch) < self.policy.max_batch:
            batch.append(q.popleft())
        if q is not None and not q:
            del self._groups[key]
        self._queued -= len(batch)
        self._set_depth_locked()
        return batch

    def _requeue(self, batch: List[_Entry]) -> None:
        """Put a wedged batch back at the head of its group, original
        order, unresolved — it is due again on the next flush round."""
        key = (setting_key(batch[0].setting), batch[0].family)
        with self._cond:
            q = self._groups.setdefault(key, deque())
            q.extendleft(reversed(batch))
            self._queued += len(batch)
            self._inc("wedged_flushes")
            self._set_depth_locked()
            self._cond.notify_all()
        self.obs.dump("wedged_flush",
                      group=f"{key[0]}/{key[1]}", size=len(batch))

    def _flush(self, batch: List[_Entry]) -> int:
        """One `predict_batch` for one group batch; resolve positionally.
        Returns the number of requests settled (0 if the flush wedged
        and the batch was requeued)."""
        reg = self.obs.registry
        group = f"{setting_key(batch[0].setting)}/{batch[0].family}"
        span = self.obs.tracer.start_span(
            "rpc.batcher.flush", attrs={"group": group, "size": len(batch)})
        if self.chaos is not None:
            fault = self.chaos.decide("flush")
            if fault is not None:
                if fault.kind == "wedge":
                    span.set_attr("wedged", True)
                    span.end("error")
                    self._requeue(batch)
                    return 0
                if fault.kind == "delay":
                    time.sleep(fault.delay_s)
                elif fault.kind == "error":
                    err = fault.to_error()
                    with self._cond:
                        self._inc("batches")
                        self._inc("batched_requests", len(batch))
                        self._inc("failed", len(batch))
                        reg.observe("rpc_batcher_flush_batch_size",
                                    len(batch), batcher=self._mid)
                    span.set_attr("chaos", err.code)
                    span.end("error")
                    self.obs.dump("chaos_fault", site="flush",
                                  code=err.code, group=group,
                                  size=len(batch))
                    for e in batch:
                        e.pending._fail(err)
                    return len(batch)
        graphs = [e.graph for e in batch]
        # Per-flush backend attribution: diff the service's resolved-
        # backend tally (the port's tiers: numpy, torch, cuda, and direct
        # for non-tree families) around the call.  (With overlapping flushes a
        # delta can attribute a concurrent flush's runs to this one —
        # totals stay exact, attribution is per-flush best-effort.)
        counts_fn = getattr(self.service, "backend_run_counts", None)
        before = counts_fn() if callable(counts_fn) else None
        t0 = self.obs.now()
        try:
            # Ambient-activate the flush span so the service's
            # predict_batch / kernel spans parent under it.
            with self.obs.tracer.activate(span):
                reports = self.service.predict_batch(
                    graphs, batch[0].setting, batch[0].family)
            if len(reports) != len(batch):        # defensive: cross-wiring
                raise RuntimeError(
                    f"predict_batch returned {len(reports)} reports for "
                    f"{len(batch)} graphs")
        except RPCError as exc:
            err = exc
            reports = None
        except KeyError as exc:
            err = RPCError(E_UNKNOWN_SETTING, str(exc), retryable=False)
            reports = None
        except Exception as exc:
            err = RPCError(E_INTERNAL, f"{type(exc).__name__}: {exc}")
            reports = None
        dt = self.obs.now() - t0
        after = counts_fn() if before is not None else None
        with self._cond:
            self._inc("batches")
            self._inc("batched_requests", len(batch))
            reg.set_max("rpc_batcher_max_batch", len(batch),
                        batcher=self._mid)
            reg.observe("rpc_batcher_flush_batch_size", len(batch),
                        batcher=self._mid)
            reg.observe("rpc_batcher_flush_duration", dt, batcher=self._mid)
            if after is not None:
                for k, v in after.items():
                    d = v - before.get(k, 0)
                    if d > 0:
                        reg.inc("rpc_flush_backend_total", d,
                                backend=k, batcher=self._mid)
                        span.set_attr("backend", k)
            if reports is None:
                self._inc("failed", len(batch))
            else:
                self._inc("answered", len(batch))
        if reports is None:
            span.set_attr("error", err.code)
            span.end("error")
            for e in batch:
                e.pending._fail(err)
        else:
            span.end()
            for e, r in zip(batch, reports):
                e.pending._resolve(r)
        return len(batch)

    def run_pending(self, force: bool = False) -> int:
        """Flush every due group (all groups if ``force``); returns the
        number of requests answered/failed.  One batch per group per
        round, rounds repeated until nothing is due or a round makes no
        progress (every due batch chaos-wedged back onto its queue —
        those retry on the *next* pump instead of spinning here)."""
        served = 0
        while True:
            with self._cond:
                keys = self._due_keys(self.clock.now(), force)
                batches = [self._take_batch(k) for k in keys]
            batches = [b for b in batches if b]
            if not batches:
                return served
            progress = 0
            for b in batches:
                progress += self._flush(b)
            served += progress
            if progress == 0:
                return served

    def flush_all(self) -> int:
        """Drain everything immediately, deadlines notwithstanding."""
        return self.run_pending(force=True)

    # -- worker ---------------------------------------------------------------
    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def _next_deadline_ticks(self, now: int) -> Optional[int]:
        heads = [q[0].deadline for q in self._groups.values() if q]
        if not heads:
            return None
        return max(min(heads) - now, 0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed:
                    if self._due_keys(self.clock.now(), force=False):
                        break
                    self.clock.wait(
                        self._cond,
                        self._next_deadline_ticks(self.clock.now()))
                closed = self._closed
            progress = self.run_pending(force=closed)
            if closed:
                return
            if progress == 0:
                # Every due batch wedged (chaos): back off one tick so a
                # rate-1.0 wedge plan retries instead of spinning the CPU.
                with self._cond:
                    if not self._closed:
                        self.clock.wait(self._cond, 1)

    # -- lifecycle / introspection -------------------------------------------
    def close(self) -> None:
        """Stop accepting work, drain the queue, stop the worker.

        Exactly-once holds through shutdown: anything still queued after
        the final drain (possible only when a chaos wedge plan keeps
        re-queuing its batches) fails with a typed retryable
        ``unavailable`` instead of leaving callers blocked forever."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
        else:
            self.run_pending(force=True)
        with self._cond:
            leftovers = [e for q in self._groups.values() for e in q]
            self._groups.clear()
            self._queued = 0
            if leftovers:
                self._inc("failed", len(leftovers))
            self._set_depth_locked()
        err = RPCError(E_UNAVAILABLE, "batcher closed before flush")
        for e in leftovers:
            e.pending._fail(err)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def queued(self) -> int:
        with self._cond:
            return self._queued

    # Registry-backed counter views: the numbers live in the obs
    # registry (one source of truth for stats(), the metrics endpoint,
    # and Prometheus exposition); these properties keep the original
    # attribute API intact.
    @property
    def submitted(self) -> int: return self._cnt("submitted")

    @property
    def answered(self) -> int: return self._cnt("answered")

    @property
    def failed(self) -> int: return self._cnt("failed")

    @property
    def rejected(self) -> int: return self._cnt("rejected")

    @property
    def shed_cache_only(self) -> int: return self._cnt("shed_cache_only")

    @property
    def shed_rejected(self) -> int: return self._cnt("shed_rejected")

    @property
    def wedged_flushes(self) -> int: return self._cnt("wedged_flushes")

    @property
    def short_circuits(self) -> int: return self._cnt("short_circuits")

    @property
    def batches(self) -> int: return self._cnt("batches")

    @property
    def batched_requests(self) -> int: return self._cnt("batched_requests")

    @property
    def max_batch_observed(self) -> int:
        return int(self.obs.registry.get("rpc_batcher_max_batch",
                                         batcher=self._mid))

    @property
    def flush_backends(self) -> Dict[str, int]:
        vals = self.obs.registry.labeled_values(
            "rpc_flush_backend_total", "backend", batcher=self._mid)
        return {k: int(v) for k, v in vals.items()}

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            shed_tier = self._shed_tier_locked(self.clock.now())
            queued = self._queued
        batches = self.batches
        batched = self.batched_requests
        return {
            "submitted": self.submitted,
            "answered": self.answered,
            "failed": self.failed,
            "rejected": self.rejected,
            "shed_tier": shed_tier,
            "shed_cache_only": self.shed_cache_only,
            "shed_rejected": self.shed_rejected,
            "wedged_flushes": self.wedged_flushes,
            "short_circuits": self.short_circuits,
            "batches": batches,
            "batched_requests": batched,
            "max_batch_observed": self.max_batch_observed,
            "flush_backends": self.flush_backends,
            "avg_batch": (batched / batches if batches else 0.0),
            "queued": queued,
            "policy": {"max_batch": self.policy.max_batch,
                       "max_wait_ticks": self.policy.max_wait_ticks,
                       "max_queue": self.policy.max_queue,
                       "shed_frac": self.policy.shed_frac,
                       "shed_reject_ticks": self.policy.shed_reject_ticks},
        }


__all__ = ["BatchPolicy", "ManualClock", "MicroBatcher", "MonotonicClock",
           "PendingResult"]
