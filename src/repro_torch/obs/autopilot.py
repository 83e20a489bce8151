"""Drift-triggered recalibration autopilot — the observability layer's
control plane.

The drift monitor (`DriftMonitor`) gives the stack a drift *signal*;
this module closes the loop's actuation half.  A `RecalibrationAutopilot`
subscribes to an `AlertEngine`'s drift alerts and, on each fire,
executes the full self-healing sequence:

  1. **target** — `DriftMonitor.worst_cells` names the offending
     (setting, op-type) cells; the worst *registered* setting is chosen
     and its offending op types become the recalibration focus;
  2. **plan + recalibrate** — a `TransferEngine` with
     ``focus_op_types`` concentrates a budget-K sample plan
     (`sampler.plan_samples` strata) on those types, measures them
     through a *fresh* profiling session from the registered factory
     (fresh, because a session's latency cache would replay
     pre-drift values), and fits refreshed calibration maps;
  3. **rollout** — the new bank rolls out through the injected
     ``rollout`` callable — `hub.swap_bank` in-process by default, or a
     client's ``rollover`` RPC for a remote server — returning the new
     epoch; in-flight flushes finish on the bank they snapshotted;
  4. **reset** — the setting's drift cells are cleared so the score
     reflects only post-rollout evidence (the alert rule then clears
     and re-arms via its hysteresis band).

Every step is spanned (trace-linked to the alert event's trace id) and
every decision — including *suppressed* actions (cooldown, rate
window, no registered target) — is an `AuditLog` event, so a closed
loop run is reconstructable, and bit-comparable across replays, from
the audit log + span tree alone.  Under a `ManualClock` and a seeded
synthetic drift (`SyntheticDevice.warp_shift`) the whole loop is
deterministic end to end.

Anti-flap guards: per-setting ``cooldown`` between actions, and at
most ``max_actions_per_window`` actions per sliding ``window`` across
all settings.  All time arithmetic uses the *alert's* timestamp, not a
fresh clock read, so guard decisions replay exactly.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.alerts import AlertEngine
from repro_torch.obs.metrics import _num

__all__ = ["AutopilotConfig", "RecalibrationAutopilot"]


@dataclass(frozen=True)
class AutopilotConfig:
    """Knobs of the closed loop (see docs/PIPELINE.md for the table)."""

    rule: str = "drift"                # alert rule name that triggers action
    budget_k: int = 48                 # total measurements per recalibration
    top_k_cells: int = 4               # drift cells considered for targeting
    cooldown: float = 16.0             # min clock units between actions/setting
    max_actions_per_window: int = 2    # global action cap per window
    window: float = 128.0              # sliding rate-limit window
    family: str = "gbdt"               # predictor family to refresh
    strata: int = 4                    # sampler latency strata
    max_e2e_probes: int = 4            # composition probes within the budget
    focus_frac: float = 0.5            # op budget share for offending types
    seed: int = 0                      # sampler seed (replay determinism)

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "budget_k": self.budget_k,
                "top_k_cells": self.top_k_cells,
                "cooldown": _num(self.cooldown),
                "max_actions_per_window": self.max_actions_per_window,
                "window": _num(self.window), "family": self.family,
                "strata": self.strata, "max_e2e_probes": self.max_e2e_probes,
                "focus_frac": _num(self.focus_frac), "seed": self.seed}


class RecalibrationAutopilot:
    """Subscribes to drift alerts; plans, recalibrates, and rolls out."""

    def __init__(self, obs: Any, engine: AlertEngine, hub: Any,
                 source_store: Any, source_setting: Any, *,
                 config: Optional[AutopilotConfig] = None,
                 rollout: Optional[Callable[..., int]] = None):
        self.obs = obs
        self.engine = engine
        self.hub = hub
        self.source_store = source_store
        self.source_setting = source_setting
        self.config = config or AutopilotConfig()
        self.audit = engine.audit
        # rollout(target_setting, family, bank) -> new epoch.  Default:
        # the in-process zero-downtime swap; inject a client's
        # ``rollover`` RPC to actuate a remote server instead.
        self._rollout = rollout or (
            lambda setting, family, bank: hub.swap_bank(setting, family,
                                                        bank))
        self._lock = threading.RLock()
        self._targets: Dict[str, Dict[str, Any]] = {}
        self._last_action: Dict[str, float] = {}
        self._action_times: List[float] = []
        self.actions: List[Dict[str, Any]] = []
        self.suppressed = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for name in ("autopilot_actions_total",
                     "autopilot_suppressed_total"):
            self.obs.registry.counter(name)
        engine.subscribe(self._on_alert)

    # -- device registration --------------------------------------------------
    def register_device(self, target_setting: Any,
                        session_factory: Callable[[], Any], *,
                        probe_graphs: Optional[List[Any]] = None) -> str:
        """Make a served setting recalibratable.  ``session_factory``
        must return a *fresh* measuring session against the device's
        current (possibly drifted) behavior on every call — a reused
        session's latency cache would replay stale values."""
        from repro_torch.pipeline.store import setting_key
        sk = setting_key(target_setting)
        with self._lock:
            self._targets[sk] = {"setting": target_setting,
                                 "session_factory": session_factory,
                                 "probe_graphs": probe_graphs}
        return sk

    # -- the loop -------------------------------------------------------------
    def step(self, *, force_sample: bool = False) -> List[Dict[str, Any]]:
        """One control-loop tick: sample the timeline (interval-gated)
        and evaluate the alert rules; any drift fire actuates
        synchronously inside this call."""
        self.engine.timeline.sample(force=force_sample)
        return self.engine.evaluate()

    def start(self, poll_s: float = 0.05) -> None:
        """Run `step` on a background thread (serving deployments; the
        deterministic tests drive `step` themselves)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:      # the loop must outlive one bad tick
                    self.obs.dump("autopilot_step_error")
                self._stop.wait(poll_s)

        self._thread = threading.Thread(target=loop, name="autopilot",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- alert handling -------------------------------------------------------
    def _on_alert(self, event: Dict[str, Any]) -> None:
        if event.get("kind") != "fire" or event.get("rule") != self.config.rule:
            return
        try:
            self._act(event)
        except Exception as exc:
            # A failed action must not kill the evaluation loop (or the
            # serving thread driving it) — record loudly instead.
            self.obs.registry.inc("autopilot_suppressed_total",
                                  reason="error")
            self.audit.record("autopilot.error", float(event["t"]),
                              error=f"{type(exc).__name__}: {exc}",
                              rule=event.get("rule"))
            self.obs.dump("autopilot_error",
                          error=f"{type(exc).__name__}: {exc}")

    def _suppress(self, now: float, reason: str, **fields: Any) -> None:
        with self._lock:
            self.suppressed += 1
        self.obs.registry.inc("autopilot_suppressed_total", reason=reason)
        self.audit.record("autopilot.suppressed", now, reason=reason,
                          **fields)

    def _act(self, event: Dict[str, Any]) -> None:
        cfg = self.config
        now = float(event["t"])        # the alert's clock, for replayability
        with self._lock:
            self._action_times = [t for t in self._action_times
                                  if now - t < cfg.window]
            if len(self._action_times) >= cfg.max_actions_per_window:
                self._suppress(now, "rate_limit",
                               window=_num(cfg.window),
                               max_actions=cfg.max_actions_per_window)
                return
            targets = dict(self._targets)
            last_action = dict(self._last_action)
        cells = self.obs.drift.worst_cells(cfg.top_k_cells)
        candidates = [c for c in cells if c["setting"] in targets]
        if not candidates:
            self._suppress(now, "no_registered_target",
                           cells=[[c["setting"], c["op_type"]]
                                  for c in cells])
            return
        sk = candidates[0]["setting"]
        if now - last_action.get(sk, float("-inf")) < cfg.cooldown:
            self._suppress(now, "cooldown", setting=sk,
                           cooldown=_num(cfg.cooldown))
            return
        focus = sorted({c["op_type"] for c in candidates
                        if c["setting"] == sk})
        trace = ({"tid": event["tid"], "sid": event["sid"]}
                 if event.get("tid") else None)
        span = self.obs.tracer.start_span(
            "autopilot.action", trace=trace,
            attrs={"rule": event["rule"], "setting": sk,
                   "budget_k": cfg.budget_k})
        try:
            with self.obs.tracer.activate(span):
                epoch, result = self._recalibrate(now, sk, targets[sk],
                                                  focus, candidates)
            span.set_attr("epoch", epoch)
            span.end("ok")
        except Exception:
            span.end("error")
            raise
        with self._lock:
            self._last_action[sk] = now
            self._action_times.append(now)
            self.actions.append({
                "t": _num(now), "setting": sk, "epoch": epoch,
                "focus_op_types": focus,
                "n_measurements": result.n_measurements,
                "composition": result.composition,
            })
        self.obs.registry.inc("autopilot_actions_total", setting=sk)

    def _recalibrate(self, now: float, sk: str, target: Dict[str, Any],
                     focus: List[str], candidates: List[Dict[str, Any]]):
        """plan → adapt → rollout → drift reset, each step audited."""
        # Imported here, not at module top: repro_torch.pipeline imports
        # repro_torch.obs — the control plane sits above both layers.
        from repro_torch.pipeline.hub import PredictorHub
        from repro_torch.transfer.engine import TransferEngine

        cfg = self.config
        tracer = self.obs.tracer
        source_bank = self.hub.get(self.source_setting, cfg.family)
        if source_bank is None:
            raise RuntimeError(
                f"no source bank for family {cfg.family!r} — the autopilot "
                f"cannot plan a recalibration without one")
        self.audit.record(
            "autopilot.plan", now, setting=sk, budget_k=cfg.budget_k,
            focus_op_types=focus,
            cells=[[c["setting"], c["op_type"], _num(round(c["score"], 6))]
                   for c in candidates if c["setting"] == sk])

        # Adapt against a scratch hub holding only the source bank:
        # the serving hub's epoch must move exactly once, at rollout.
        with tracer.span("autopilot.recalibrate",
                         attrs={"setting": sk, "focus": ",".join(focus)}):
            scratch = PredictorHub(device=self.hub.device)
            scratch.register(self.source_setting, cfg.family, source_bank)
            engine = TransferEngine(
                self.source_setting, target["setting"], family=cfg.family,
                seed=cfg.seed, strata=cfg.strata,
                max_e2e_probes=cfg.max_e2e_probes,
                probe_graphs=target["probe_graphs"],
                focus_op_types=focus, focus_frac=cfg.focus_frac)
            session = target["session_factory"]()
            result = engine.adapt(self.source_store, scratch, session,
                                  cfg.budget_k)
        self.audit.record(
            "autopilot.recalibrate", now, setting=sk,
            n_op_measurements=result.n_op_measurements,
            n_e2e_measurements=result.n_e2e_measurements,
            map_kinds=dict(sorted(result.map_kinds.items())),
            composition=result.composition)

        with tracer.span("autopilot.rollover", attrs={"setting": sk}):
            epoch = int(self._rollout(target["setting"], cfg.family,
                                      result.bank))
        self.audit.record("autopilot.rollover", now, setting=sk,
                          family=cfg.family, epoch=epoch)

        self.obs.drift.reset(sk)
        self.audit.record("autopilot.drift_reset", now, setting=sk)
        return epoch, result

    # -- introspection --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """Compact live view, served through the ``health`` RPC."""
        with self._lock:
            last = dict(self.actions[-1]) if self.actions else None
            return {"rule": self.config.rule,
                    "running": self._thread is not None,
                    "targets": sorted(self._targets),
                    "actions": len(self.actions),
                    "suppressed": self.suppressed,
                    "firing": self.engine.firing(),
                    "last_action": last}

    def stats(self) -> Dict[str, Any]:
        return self.status()

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "RecalibrationAutopilot":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
