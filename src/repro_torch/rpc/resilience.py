"""Client-side fault-tolerance policies: retry/backoff + circuit breaker.

`RetryPolicy` is deliberately deterministic: the jittered backoff
schedule is a pure function of the policy's seed (`backoff_schedule`),
so tests assert the exact delays a failing call will sleep instead of
sampling wall clocks.  Retries are budgeted — every attempt draws from
one per-call deadline, and the sleep before a retry never overshoots
the remaining budget.

Only errors the server marked ``retryable`` (the typed envelopes of
`repro_torch.rpc.protocol`) are retried; everything else surfaces on the
first attempt.  `retry_call` is transport-agnostic — `LatencyClient`
threads it through its socket send/wait, but anything raising
`RPCError` can use it.

`CircuitBreaker` keeps a hammering client from burying an unhealthy
server: ``failure_threshold`` consecutive retryable failures open the
circuit, calls fail fast (``unavailable``, retryable) for
``reset_after_s``, then one half-open probe decides whether to close
it again.  Time is injectable for determinism.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from repro_torch.rpc.protocol import E_TIMEOUT, E_UNAVAILABLE, RPCError


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with seeded jitter (see module doc)."""

    max_attempts: int = 4        # total tries, including the first
    base_delay_s: float = 0.05   # delay before the first retry...
    multiplier: float = 2.0      # ...growing by this per retry...
    max_delay_s: float = 2.0     # ...capped here (before jitter)
    jitter: float = 0.5          # ± fraction drawn from the seeded RNG
    deadline_s: float = 30.0     # per-call wall budget across attempts
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")

    def backoff_schedule(self, attempts: Optional[int] = None,
                         seed: Optional[int] = None) -> List[float]:
        """The exact delays (seconds) slept before retry 1, 2, … —
        deterministic per seed; tests compare against this verbatim."""
        rng = random.Random(self.seed if seed is None else seed)
        n = (self.max_attempts - 1) if attempts is None else attempts
        out = []
        for k in range(max(n, 0)):
            base = min(self.base_delay_s * self.multiplier ** k,
                       self.max_delay_s)
            out.append(base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
        return out


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing (thread-safe)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 reset_after_s: float = 1.0, *,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opens = 0            # lifetime open transitions (introspection)

    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_after_s):
            self._state = self.HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """May a call proceed right now?  In half-open, exactly one
        probe is admitted until it reports success/failure."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN:
                # Failed probe: same outage continues — re-open without
                # counting a fresh open transition.
                self._trip_locked(count=False)
            elif self._state == self.CLOSED \
                    and self._failures >= self.failure_threshold:
                self._trip_locked(count=True)

    def _trip_locked(self, count: bool) -> None:
        if count and self._state != self.OPEN:
            self.opens += 1
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._probing = False


def retry_call(attempt: Callable[[float], Any], policy: RetryPolicy, *,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               breaker: Optional[CircuitBreaker] = None,
               deadline_s: Optional[float] = None,
               on_retry: Optional[Callable[[int, RPCError, float],
                                           None]] = None) -> Any:
    """Run ``attempt(budget_s)`` under ``policy``.

    ``attempt`` receives the remaining deadline budget (to cap its own
    wait) and either returns the result or raises `RPCError`.  Only
    ``retryable`` errors are retried; the backoff slept before retry k
    is exactly ``policy.backoff_schedule()[k-1]`` (clipped to the
    remaining budget).  ``on_retry(attempt_no, err, delay_s)`` observes
    each retry — tests hook it to pin the schedule.
    """
    deadline = clock() + (policy.deadline_s if deadline_s is None
                          else float(deadline_s))
    delays = policy.backoff_schedule()
    failures = 0
    while True:
        if breaker is not None and not breaker.allow():
            raise RPCError(E_UNAVAILABLE,
                           "circuit breaker open (server deemed unhealthy)")
        budget = deadline - clock()
        if budget <= 0:
            raise RPCError(E_TIMEOUT,
                           f"retry deadline exhausted after {failures} "
                           f"failed attempts")
        try:
            result = attempt(budget)
        except RPCError as exc:
            if breaker is not None:
                breaker.record_failure()
            if not exc.retryable:
                raise
            failures += 1
            if failures >= policy.max_attempts:
                raise
            delay = min(delays[failures - 1], max(deadline - clock(), 0.0))
            if on_retry is not None:
                on_retry(failures, exc, delay)
            if delay > 0:
                sleep(delay)
            continue
        if breaker is not None:
            breaker.record_success()
        return result


__all__ = ["CircuitBreaker", "RetryPolicy", "retry_call"]
