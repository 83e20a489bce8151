"""Span-based request tracing with deterministic ids and a flight recorder.

A `Tracer` hands out `Span`s — named intervals with attributes, a
trace id shared along one request's journey, and a span id unique
within the tracer.  Ids are *counter-based* (``t<seed>-<n>`` /
``s<n>``), not random, so a seeded replay of the same workload
produces the same span tree; the clock is injectable (any object with
``.now()`` or a zero-arg callable), so under a `ManualClock` spans
carry tick timestamps and two runs are bit-identical.

Parentage is ambient per thread: entering a span (``with``) pushes it
on a thread-local stack and nested spans auto-parent; cross-thread /
cross-process edges pass an explicit wire context
(``{"tid": ..., "sid": ...}`` — the protocol's optional ``trace``
field) to `start_span`.

The `FlightRecorder` keeps the last N finished spans in a ring; on a
fault (chaos injection, wedged flush, deadline timeout) `dump()`
snapshots the ring into a schema-stable dict — the "what was the
system doing right before it went wrong" artifact, bounded in memory
and validated by `validate_dump`.

Spans inside a training step (the port's own; see "Spans inside a
training step" below): `train_step` traces one step of
`repro_torch.distributed.make_train_step` while a torch.profiler
session records in the process or the step's tracer is enabled, and
model code opens its spans with `train_span`, from any thread.  Under
the profiler each such span is also a profiler range of its name, so
the profiler's trace gives it the device time of the kernels launched
under it.  A span's attribute may be a 0-d tensor (a counter left on
the device); `Tracer.export` turns it into a number.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["Span", "Tracer", "FlightRecorder", "validate_dump", "NOOP_SPAN",
           "TrainSpan", "train_step", "train_span"]


def _now_fn(clock: Any) -> Callable[[], float]:
    if clock is None:
        return time.perf_counter
    if hasattr(clock, "now"):
        return clock.now
    if callable(clock):
        return clock
    raise TypeError("clock must expose .now() or be callable")


class _NoopSpan:
    """Inert span: tracing disabled costs attribute lookups, not objects."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def set_attr(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def end(self, status: str = "ok") -> None:
        pass

    def inputs(self, *xs: Any) -> Tuple[Any, ...]:
        return xs

    def output(self, x: Any) -> Any:
        return x

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "start", "end_at", "status", "attrs")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], start: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_at: Optional[float] = None
        self.status = "ok"
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def end(self, status: str = "ok") -> None:
        if self.end_at is not None:
            return                              # idempotent
        self.status = status
        self._tracer._finish(self)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "tid": self.trace_id, "sid": self.span_id,
            "parent": self.parent_id, "start": self.start,
            "end": self.end_at, "status": self.status,
            "attrs": dict(self.attrs),
        }

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type: Any, *exc: Any) -> bool:
        self._tracer._pop(self)
        self.end("error" if exc_type is not None else "ok")
        return False


class Tracer:
    """Deterministic span factory (see module docstring)."""

    def __init__(self, *, clock: Any = None, seed: int = 0,
                 recorder: Optional["FlightRecorder"] = None,
                 enabled: bool = True, capacity: int = 4096):
        self.enabled = bool(enabled)
        self.seed = int(seed)
        self.recorder = recorder
        self._now = _now_fn(clock)
        self._lock = threading.Lock()
        self._trace_n = 0
        self._span_n = 0
        self._finished: deque = deque(maxlen=capacity)
        self._tls = threading.local()

    def now(self) -> float:
        """The tracer's injected time source (ticks under a ManualClock,
        perf_counter by default) — components share it for duration
        histograms so metrics and spans agree on what 'time' means."""
        return self._now()

    # -- ids ------------------------------------------------------------------
    def _new_ids(self, want_trace: bool) -> Any:
        with self._lock:
            self._span_n += 1
            sid = f"s{self._span_n:06d}"
            if not want_trace:
                return sid
            self._trace_n += 1
            return sid, f"t{self.seed:08x}-{self._trace_n:06d}"

    # -- ambient stack --------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- span lifecycle -------------------------------------------------------
    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   trace: Optional[Dict[str, Any]] = None,
                   attrs: Optional[Dict[str, Any]] = None) -> Any:
        """A new span (NOT entered — call `end` or use ``with``).

        Parent resolution: explicit wire ``trace`` ({"tid", "sid"}) >
        explicit ``parent`` span > the thread's ambient current span >
        a fresh trace."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, *self._place(parent, trace), self._now(), attrs)

    def _place(self, parent: Optional[Span], trace: Optional[Dict[str, Any]]
               ) -> Tuple[str, str, Optional[str]]:
        """(trace id, span id, parent id) of a new span (see `start_span`)."""
        if trace is not None and trace.get("tid"):
            tid = str(trace["tid"])
            pid = str(trace.get("sid")) if trace.get("sid") else None
            sid = self._new_ids(want_trace=False)
        else:
            anchor = parent if parent is not None else self.current()
            if isinstance(anchor, Span):
                tid, pid = anchor.trace_id, anchor.span_id
                sid = self._new_ids(want_trace=False)
            else:
                sid, tid = self._new_ids(want_trace=True)
                pid = None
        return tid, sid, pid

    def span(self, name: str, *, parent: Optional[Span] = None,
             trace: Optional[Dict[str, Any]] = None,
             attrs: Optional[Dict[str, Any]] = None) -> Any:
        """`start_span`, intended for ``with`` (ambient push/pop + end)."""
        return self.start_span(name, parent=parent, trace=trace, attrs=attrs)

    @contextmanager
    def activate(self, span: Any) -> Iterator[Any]:
        """Make ``span`` the thread's ambient parent for the block —
        WITHOUT ending it on exit (the owner ends it, possibly later on
        another thread, e.g. a batcher completion callback)."""
        if isinstance(span, Span):
            self._push(span)
            try:
                yield span
            finally:
                self._pop(span)
        else:
            yield span

    def event(self, name: str, *, trace: Optional[Dict[str, Any]] = None,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration point span (retry, reconnect, shed, ...)."""
        sp = self.start_span(name, trace=trace, attrs=attrs)
        sp.end()

    def _finish(self, span: Span) -> None:
        span.end_at = self._now()
        d = span.to_json()
        with self._lock:
            self._finished.append(d)
        if self.recorder is not None:
            self.recorder.record(d)

    @staticmethod
    def wire_context(span: Any) -> Optional[Dict[str, str]]:
        """The span's propagation payload for the protocol ``trace``
        field (None for noop spans — nothing goes on the wire)."""
        if span is None or span.trace_id is None:
            return None
        return {"tid": span.trace_id, "sid": span.span_id}

    def export(self) -> List[Dict[str, Any]]:
        """Finished spans, oldest first (bounded by ``capacity``); a
        counter held as a tensor is read here (its first export waits
        for the device) and kept as a number."""
        with self._lock:
            out = list(self._finished)
        for d in out:
            attrs = d["attrs"]
            for k, v in attrs.items():
                if isinstance(v, torch.Tensor):
                    attrs[k] = v.item()
        return out


# ---------------------------------------------------------------------------
# Spans inside a training step
# ---------------------------------------------------------------------------
#
# `train_step` makes one step's `_TrainTrace` the process's ambient one
# while the step runs, so model code reaches it through `train_span`
# without new arguments, from any thread: on the card the autograd engine
# runs the backward (and the recompute of every checkpointed layer) on a
# thread of its own, whose spans take the stepping thread's innermost
# span (`train.backward`) as their parent.  With no traced step running,
# `train_span` costs one global read and returns NOOP_SPAN, and a span's
# `inputs` and `output` hand their tensors back untouched: no node is
# added to the autograd graph and no kernel launched.

_ACTIVE: Optional["_TrainTrace"] = None


class TrainSpan(Span):
    """A span of a traced training step.  Under the profiler it also
    holds a profiler range of its name (`_RecordFunctionFast`: listed as
    an op, not as a user annotation), so the trace gives the span the
    device time of the kernels launched under it on its thread.

    ``inputs`` and ``output`` mark a region for the backward: the
    region's tensors pass through identity functions whose backward opens
    the span ``<name>.bwd`` when the outputs' gradient arrives and ends it
    once every input's gradient is ready.  Values and gradients are the
    same bits as without them."""

    __slots__ = ("_range", "_trace", "_bwd")

    def __init__(self, trace: "_TrainTrace", name: str, parent: Optional[Span]):
        tracer = trace.tracer
        super().__init__(tracer, name, *tracer._place(parent, None), tracer._now())
        self._trace = trace
        self._bwd: Optional[_Backward] = None
        self._range = None
        if trace.profile:
            self._range = torch._C._profiler._RecordFunctionFast(name)
            self._range.__enter__()

    def close(self, status: str = "ok") -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end(status)

    def __enter__(self) -> "TrainSpan":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type: Any, *exc: Any) -> bool:
        self._tracer._pop(self)
        # A checkpointed layer's recompute stops by raising once it has
        # every tensor the backward needs: the span ends there, no error.
        fine = exc_type is None or exc_type.__name__ == "_StopRecomputationError"
        self.close("ok" if fine else "error")
        return False

    def inputs(self, *xs: Any) -> Tuple[Any, ...]:
        """``xs`` with those that need a gradient marked as the region's
        inputs (the others as they are)."""
        want = [i for i, x in enumerate(xs)
                if isinstance(x, torch.Tensor) and x.requires_grad]
        if not want or not torch.is_grad_enabled():
            return xs
        self._bwd = _Backward(self._trace, self.name + ".bwd")
        marked = _RegionIn.apply(self._bwd, *(xs[i] for i in want))
        out = list(xs)
        for i, m in zip(want, marked):
            out[i] = m
        return tuple(out)

    def output(self, x: Any) -> Any:
        """``x`` marked as the region's output, where ``inputs`` marked
        the region's inputs."""
        if self._bwd is None or not (isinstance(x, torch.Tensor) and x.requires_grad):
            return x
        return _RegionOut.apply(self._bwd, x)


class _Backward:
    """The ``.bwd`` span of one marked region, open from the outputs'
    gradient to the inputs'."""

    __slots__ = ("trace", "name", "span")

    def __init__(self, trace: "_TrainTrace", name: str):
        self.trace, self.name, self.span = trace, name, None

    def open(self) -> None:
        if self.span is None:
            self.span = self.trace.span(self.name, anchored=True)
            self.trace.open.add(self)

    def close(self, status: str = "ok") -> None:
        if self.span is not None:
            self.span.close(status)
            self.span = None
            self.trace.open.discard(self)


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bwd, x):
        ctx.bwd = bwd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.bwd.open()
        return None, g


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.bwd = bwd
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.bwd.close()
        return (None, *gs)


class _TrainTrace:
    """One traced step: its tracer, whether the profiler records, the
    stepping thread's span stack, and the ``.bwd`` spans still open."""

    __slots__ = ("tracer", "profile", "main", "open")

    def __init__(self, tracer: Tracer, profile: bool):
        self.tracer, self.profile = tracer, profile
        self.main = tracer._stack()
        self.open: set = set()

    def span(self, name: str, anchored: bool = False) -> TrainSpan:
        """A new span under this thread's innermost one; on a thread with
        none (autograd's), or ``anchored``, under the stepping thread's."""
        parent = None if anchored else self.tracer.current()
        if parent is None and self.main:
            parent = self.main[-1]
        return TrainSpan(self, name, parent)


@contextmanager
def train_step(tracer: Tracer) -> Iterator[Any]:
    """Trace one training step into ``tracer`` as ``train.step`` when the
    tracer is enabled or a torch.profiler session records (decided here,
    once a step); otherwise yield NOOP_SPAN and trace nothing."""
    global _ACTIVE
    profile = torch.autograd.profiler._is_profiler_enabled
    if not (profile or tracer.enabled):
        yield NOOP_SPAN
        return
    trace, outer = _TrainTrace(tracer, profile), _ACTIVE
    _ACTIVE = trace
    try:
        with trace.span("train.step") as root:
            try:
                yield root
            finally:
                # A region whose inputs' gradient was never asked for.
                for bwd in list(trace.open):
                    bwd.close("error")
    finally:
        _ACTIVE = outer


def train_span(name: str) -> Any:
    """A span of the traced step running in this process (enter it with
    ``with``), or NOOP_SPAN when none is."""
    trace = _ACTIVE
    return NOOP_SPAN if trace is None else trace.span(name)


class FlightRecorder:
    """Bounded ring of finished spans + bounded list of fault dumps."""

    def __init__(self, capacity: int = 256, max_dumps: int = 32):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self.dumps: deque = deque(maxlen=int(max_dumps))
        self.dumps_dropped = 0         # evicted past max_dumps (silent loss)

    def record(self, span_json: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(span_json)

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str,
             attrs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Snapshot the ring under a fault ``reason``; kept (bounded) in
        ``dumps`` and returned for immediate logging/serving."""
        with self._lock:
            d = {"reason": str(reason), "attrs": dict(attrs or {}),
                 "spans": list(self._ring)}
            if (self.dumps.maxlen is not None
                    and len(self.dumps) == self.dumps.maxlen):
                self.dumps_dropped += 1
            self.dumps.append(d)
        return d

    def last_dump(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.dumps[-1] if self.dumps else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"ring_spans": len(self._ring), "dumps": len(self.dumps),
                    "dumps_dropped": self.dumps_dropped,
                    "last_reason": (self.dumps[-1]["reason"]
                                    if self.dumps else None)}


_SPAN_KEYS = {"name", "tid", "sid", "parent", "start", "end", "status",
              "attrs"}


def validate_dump(d: Any) -> Dict[str, Any]:
    """Schema check for a flight-recorder dump; raises ValueError with
    the first violation (CI smoke asserts dumps stay machine-readable)."""
    if not isinstance(d, dict):
        raise ValueError(f"dump must be a dict, got {type(d).__name__}")
    if not isinstance(d.get("reason"), str) or not d["reason"]:
        raise ValueError("dump.reason must be a non-empty string")
    if not isinstance(d.get("attrs"), dict):
        raise ValueError("dump.attrs must be a dict")
    spans = d.get("spans")
    if not isinstance(spans, list):
        raise ValueError("dump.spans must be a list")
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            raise ValueError(f"span[{i}] is not a dict")
        missing = _SPAN_KEYS - set(s)
        if missing:
            raise ValueError(f"span[{i}] missing keys {sorted(missing)}")
        if not isinstance(s["name"], str) or not isinstance(s["sid"], str):
            raise ValueError(f"span[{i}] name/sid must be strings")
        if s["status"] not in ("ok", "error"):
            raise ValueError(f"span[{i}] bad status {s['status']!r}")
    return d
