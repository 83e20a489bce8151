"""Latency-prediction serving layer (twin of ``repro.rpc``).

Fronts a `repro_torch.pipeline.LatencyService` with a process-local RPC
stack: many concurrent single-graph requests coalesce in a
deterministic micro-batching queue into the batched fast path (on the
card, the fused tree kernel), over a versioned JSON-lines protocol with
typed error envelopes:

    protocol   — wire format v1: requests/responses, error codes,
                 graph/setting/report (de)serialization
    batcher    — `MicroBatcher` + `BatchPolicy` (tiered load shedding)
                 + injectable clocks (`MonotonicClock`, `ManualClock`)
    server     — `LatencyRPCServer`: threaded TCP / stream transports,
                 search-front + health + rollover endpoints
    client     — `LatencyClient`: pipelined, thread-safe, service-shaped,
                 auto-reconnecting
    resilience — `RetryPolicy` (deterministic seeded backoff),
                 `CircuitBreaker`, `retry_call`
    chaos      — `FaultPlan`/`FaultSpec`: seeded, replayable fault
                 injection into dispatch, flush, and transport
"""
from repro_torch.rpc.batcher import (BatchPolicy, ManualClock, MicroBatcher,
                                     MonotonicClock, PendingResult)
from repro_torch.rpc.chaos import (FaultPlan, FaultSpec, SITE_DISPATCH,
                                   SITE_FLUSH, SITE_TRANSPORT)
from repro_torch.rpc.client import LatencyClient
from repro_torch.rpc.protocol import (PROTOCOL_VERSION, Request, Response,
                                      RPCError, decode_request,
                                      decode_response, encode_request,
                                      encode_response)
from repro_torch.rpc.resilience import CircuitBreaker, RetryPolicy, retry_call
from repro_torch.rpc.server import LatencyRPCServer

__all__ = [
    "BatchPolicy", "CircuitBreaker", "FaultPlan", "FaultSpec",
    "LatencyClient", "LatencyRPCServer", "ManualClock", "MicroBatcher",
    "MonotonicClock", "PROTOCOL_VERSION", "PendingResult", "RPCError",
    "Request", "Response", "RetryPolicy", "SITE_DISPATCH", "SITE_FLUSH",
    "SITE_TRANSPORT", "decode_request", "decode_response", "encode_request",
    "encode_response", "retry_call",
]
