"""Deterministic chaos-injection harness for the serving stack.

Fault tolerance is only trustworthy if the failures it survives can be
*replayed*.  A `FaultPlan` is a pure function of its seed: whether the
i-th event at an injection site faults is decided by hashing
``(seed, site, spec index, i)`` — no RNG state, no wall clock — so the
same plan produces bit-identical fault schedules across runs, threads,
and machines.  Thread interleavings may change *which request* lands on
a faulting index, but the schedule itself (which indices fault, and
how) never moves, which is what the replay tests pin.

Injection sites (each site keeps its own event counter):

    ``dispatch``   — `LatencyRPCServer.dispatch`: one decision per
                     request; ``error`` answers with the spec's typed
                     envelope instead of handling, ``delay`` stalls the
                     handler (a slow-server latency spike).
    ``flush``      — `MicroBatcher._flush`: one decision per batch;
                     ``error`` fails the whole batch with a typed
                     envelope, ``wedge`` re-queues it unserved (a stuck
                     flush — retried on a later round), ``delay``
                     stalls the flush.
    ``transport``  — `LatencyRPCServer.serve_stream`: one decision per
                     response write; ``drop`` severs the connection
                     (the client sees EOF and must reconnect/retry).

A plan is shared across sites, so one seed drives a whole scenario.
`FaultPlan.schedule(site, n)` previews the first ``n`` decisions for a
site without consuming them — tests use it to compute the expected
retry/backoff trace in closed form.
"""
from __future__ import annotations

import hashlib
import struct
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.rpc.protocol import E_INTERNAL, RPCError

# Injection-site names (free-form strings; these are the wired ones).
SITE_DISPATCH = "dispatch"
SITE_FLUSH = "flush"
SITE_TRANSPORT = "transport"

KINDS = ("error", "delay", "drop", "wedge")


def _unit(seed: int, name: str, index: int) -> float:
    """Uniform [0, 1) as a pure function of (seed, name, index)."""
    h = hashlib.sha256(f"{seed}:{name}:{index}".encode()).digest()
    return struct.unpack("<Q", h[:8])[0] / 2.0 ** 64


@dataclass(frozen=True)
class FaultSpec:
    """One fault mode at one site, firing at ``rate`` of that site's
    events (independently per event, per the plan's hash stream)."""

    site: str
    kind: str                  # "error" | "delay" | "drop" | "wedge"
    rate: float                # probability per event, in [0, 1]
    code: str = E_INTERNAL     # envelope code for kind="error"
    message: str = "injected fault"
    retryable: Optional[bool] = None   # None = the code's default
    delay_s: float = 0.0       # stall for kind="delay"

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")

    def to_error(self) -> RPCError:
        return RPCError(self.code, self.message, retryable=self.retryable)


class FaultPlan:
    """A seeded, replayable schedule of injected faults (see module
    docstring).  ``decide`` is thread-safe; ``schedule`` is pure."""

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = ()) -> None:
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._injected: Dict[Tuple[str, str], int] = {}

    # -- the pure core --------------------------------------------------------
    def decide_at(self, site: str, index: int) -> Optional[FaultSpec]:
        """The fault (if any) for the ``index``-th event at ``site`` —
        pure: no counters move, any thread gets the same answer.  Specs
        are evaluated in declaration order; the first that fires wins
        (each spec hashes its own sub-stream, so rates are independent)."""
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.rate > 0.0 and _unit(self.seed, f"{site}#{i}",
                                         index) < spec.rate:
                return spec
        return None

    def schedule(self, site: str, n: int) -> List[Optional[str]]:
        """Kinds of the first ``n`` decisions at ``site`` (None = clean)
        — a replay-stable preview that never consumes events."""
        return [(s.kind if (s := self.decide_at(site, i)) is not None
                 else None) for i in range(n)]

    # -- the consuming API the stack calls ------------------------------------
    def decide(self, site: str) -> Optional[FaultSpec]:
        """Consume one event at ``site`` and return its fault, if any."""
        with self._lock:
            index = self._counters.get(site, 0)
            self._counters[site] = index + 1
        spec = self.decide_at(site, index)
        if spec is not None:
            with self._lock:
                k = (site, spec.kind)
                self._injected[k] = self._injected.get(k, 0) + 1
        return spec

    # -- introspection --------------------------------------------------------
    def events(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)

    def injected(self) -> Dict[str, int]:
        """``{"site/kind": count}`` of faults actually injected so far."""
        with self._lock:
            return {f"{site}/{kind}": n
                    for (site, kind), n in sorted(self._injected.items())}

    def stats(self) -> Dict[str, object]:
        with self._lock:
            counters = dict(self._counters)
        return {"seed": self.seed, "specs": len(self.specs),
                "events": counters, "injected": self.injected()}


__all__ = ["FaultPlan", "FaultSpec", "KINDS", "SITE_DISPATCH", "SITE_FLUSH",
           "SITE_TRANSPORT"]
