"""Serving engine: prefill + decode with KV cache, continuous batching
(twin of ``repro.serving.engine``).

`ServeEngine` maintains a fixed-slot decode batch: finished requests
free their slot, queued requests prefill into it (continuous batching).
Prefill replays the prompt through `decode_step`, one token per step,
with token 0 in every other slot, as the reference does.  So a slot's
prefill also advances every other slot's cache length and writes a
token-0 K/V into the other active slots; a freed slot's cache is not
reset for the next request; once a slot's length reaches ``max_len`` its
cache writes are dropped and attention reads the whole cache.  These are
the reference's results, kept so the two engines agree.  The SSM and
hybrid families' Mamba caches (each layer's SSD state and conv window)
behave as the K/V cache does: a slot's prefill feeds token 0 through
every other slot's state and window, and a freed slot's state is not
reset; the engine only passes the cache along.

What differs from the reference: ``jax.jit(model.decode_step)`` is the
eager call, and the engine runs on ``device`` (the card unless the caller
asks for the CPU).  As in the reference, each measured step is counted in
the ``obs`` registry (``serve_steps_total``, ``serve_step_duration``) and,
once a step latency is predicted, fed to the drift monitor.

When constructed with a latency service and the op graph of one decode
step, the engine predicts its per-step latency up front (``predict_e2e``
of `repro_torch.pipeline.LatencyService`, or anything answering with a
`PredictionReport` or its ``to_json`` dict) and exposes per-request
completion estimates; `stats()` reports predicted against measured.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import Observability
from repro_torch.pipeline.service import PredictionReport
from repro_torch.pipeline.store import setting_key
from repro_torch.rpc.protocol import RPCError
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro.serving")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, *, batch_slots: int = 4,
                 max_len: int = 512, greedy: bool = True, extras=None,
                 latency_service=None, step_graph=None, latency_setting=None,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self.extras = extras or {}
        self.cache = model.init_cache(batch_slots, max_len, device=self.device)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._step = model.decode_step
        self._uid = 0
        self.step_report = None
        self.predicted_step_s: Optional[float] = None
        self.prediction_source: Optional[str] = None
        self._latency_service = latency_service
        self._step_graph = step_graph
        self._latency_setting = latency_setting
        # Every measured decode step feeds the drift monitor with its
        # observed-vs-predicted residual; counters/histograms live in the
        # same registry a shared bundle exposes.
        self.obs = obs or Observability.quiet()
        self._eid = self.obs.instance("engine")
        self.obs.registry.counter("serve_steps_total")
        self.obs.registry.histogram("serve_step_duration")
        if latency_service is not None and step_graph is not None:
            self.refresh_step_estimate()

    def _drift_key(self) -> str:
        if self._latency_setting is not None:
            return setting_key(self._latency_setting)
        return "serve"

    def refresh_step_estimate(self) -> Optional[float]:
        """(Re)fetch the decode-step latency prediction.

        If the prediction endpoint fails with a typed `RPCError`, the
        engine keeps serving without an estimate."""
        if self._latency_service is None or self._step_graph is None:
            return None
        try:
            report = self._latency_service.predict_e2e(
                self._step_graph, self._latency_setting)
        except RPCError as exc:
            log.warning("decode-step latency prediction unavailable "
                        "(%s: %s) — serving without an estimate",
                        exc.code, exc.message)
            return self.predicted_step_s
        self.step_report = self._as_report(report)
        self.predicted_step_s = self.step_report.e2e_s
        self.prediction_source = type(self._latency_service).__name__
        log.info("predicted decode-step latency: %.3f ms (%d kernels, "
                 "via %s)", 1e3 * self.predicted_step_s,
                 self.step_report.num_kernels, self.prediction_source)
        return self.predicted_step_s

    @staticmethod
    def _as_report(report):
        """Normalize a prediction to `PredictionReport` (wire payloads and
        in-process reports are interchangeable)."""
        if isinstance(report, dict):
            return PredictionReport.from_json(report)
        return report

    def estimate_request_s(self, prompt_len: int, max_new_tokens: int
                           ) -> Optional[float]:
        """Predicted wall-clock for one request (prefill replay + decode)."""
        if self.predicted_step_s is None:
            return None
        return self.predicted_step_s * (max(prompt_len - 1, 0) + max_new_tokens)

    @property
    def _steps(self) -> int:
        return int(self.obs.registry.get("serve_steps_total",
                                         engine=self._eid))

    def stats(self) -> Dict[str, Any]:
        # Step counters live in the obs registry; this stays a view.
        h = self.obs.registry.hist_stats("serve_step_duration",
                                         engine=self._eid)
        steps = self._steps
        measured = h["sum"] / steps if steps else None
        ratio = (measured / self.predicted_step_s
                 if measured and self.predicted_step_s else None)
        return {
            "steps": steps,
            "measured_step_s": measured,
            "predicted_step_s": self.predicted_step_s,
            "measured_over_predicted": ratio,
            "prediction_source": self.prediction_source,
            "step_bank_epoch": getattr(self.step_report, "bank_epoch", None),
        }

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        return self._uid

    # -- internals ---------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                self._prefill(slot, req)

    def _prefill(self, slot: int, req: Request) -> None:
        """Replay prompt tokens through decode_step for this slot."""
        for tok in req.prompt[:-1]:
            batch = self._batch_for(int(tok), slot)
            _, self.cache = self._step(self.params, batch, self.cache)
        req._next = int(req.prompt[-1])  # type: ignore[attr-defined]

    def _batch(self, tokens: np.ndarray) -> Dict[str, Any]:
        batch = {"token": torch.from_numpy(tokens).to(self.device)}
        batch.update(self.extras)
        return batch

    def _batch_for(self, token: int, slot: int) -> Dict[str, Any]:
        tokens = np.zeros((self.slots, 1), np.int32)
        tokens[slot, 0] = token
        return self._batch(tokens)

    def _batch_all(self) -> Dict[str, Any]:
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is not None:
                tokens[slot, 0] = getattr(req, "_next", 0)
        return self._batch(tokens)

    def step(self) -> int:
        """One decode step across all active slots; returns #finished."""
        self._admit()
        if not any(self.active):
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self._step(self.params, self._batch_all(), self.cache)
        logits = logits.float().cpu().numpy()
        dt = time.perf_counter() - t0
        self.obs.registry.inc("serve_steps_total", engine=self._eid)
        self.obs.registry.observe("serve_step_duration", dt,
                                  engine=self._eid)
        if self.predicted_step_s:
            self.obs.drift.observe(self._drift_key(), "decode_step",
                                   self.predicted_step_s, dt)
        finished = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            nxt = int(np.argmax(logits[slot]))
            req.generated.append(nxt)
            req._next = nxt  # type: ignore[attr-defined]
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.active[slot] = None
                finished += 1
        return finished

    def run(self, max_steps: int = 1000) -> List[Request]:
        all_reqs = list(self.queue)
        for _ in range(max_steps):
            self.step()
            if not self.queue and not any(self.active):
                break
        return [r for r in all_reqs if r.done]
