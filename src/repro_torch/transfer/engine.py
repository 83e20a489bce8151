"""`TransferEngine` — a new device's predictors from K measurements.

The paper's closing claim (§6) is that accurate end-to-end prediction
needs only *small amounts* of profiling data on a new device.  This
engine makes that operational on top of the profiling pipeline:

    engine = TransferEngine(source_setting, target_setting)
    result = engine.adapt(source_store, source_hub, target_session, 64)
    # → a calibrated PredictorBank registered in the hub under the
    #   target setting key; LatencyService.predict_e2e(g, target_setting)
    #   now serves the new device with zero code changes.

Budget accounting: ``budget_k`` caps *total* new target measurements —
sampled per-op timings plus a few whole-graph end-to-end probes (used
to fit the target's composition constants α/c₀/c₁, which per-op pairs
cannot see).  The engine verifies the session's counters afterwards.

The target session is duck-typed:

  * a `ReplayProfileSession` (or anything with ``measure_record`` /
    ``measure_arch_e2e``) measures straight from sampled records;
  * a plain `ProfileSession` works too when ``probe_graphs`` are given —
    sampled signatures are located in the graphs and measured on the
    real device via ``measure_op`` (no e2e probes; composition falls
    back to ratio-scaling the source constants).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.composition import PredictorBank, estimate_affine
from repro_torch.core.fusion import fuse_graph
from repro_torch.core.ir import OpGraph, op_signature
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline.hub import PredictorHub
from repro_torch.pipeline.store import ProfileStore, setting_key
from repro_torch.transfer.calibration import (CalibratedPredictor, LatencyMap,
                                        fit_latency_map, scale_map)
from repro_torch.transfer.descriptors import DeviceDescriptor, prior_scale
from repro_torch.transfer.sampler import SamplePlan, plan_samples
from repro_torch.utils.logging import get_logger

log = get_logger("repro.transfer.engine")

_EPS = 1e-12


@dataclass
class TransferResult:
    """What one `adapt` call produced and what it cost."""

    bank: PredictorBank
    target_key: str
    family: str
    budget: int
    n_op_measurements: int
    n_e2e_measurements: int
    plan: SamplePlan
    map_kinds: Dict[str, str] = field(default_factory=dict)
    default_map_kind: str = ""
    composition: str = ""          # "probes:N" | "ratio-scaled" | "source"
    focus_op_types: List[str] = field(default_factory=list)

    @property
    def n_measurements(self) -> int:
        return self.n_op_measurements + self.n_e2e_measurements

    def to_json(self) -> Dict[str, Any]:
        return {
            "target_key": self.target_key, "family": self.family,
            "budget": self.budget,
            "n_op_measurements": self.n_op_measurements,
            "n_e2e_measurements": self.n_e2e_measurements,
            "plan": self.plan.to_json(),
            "map_kinds": dict(sorted(self.map_kinds.items())),
            "default_map_kind": self.default_map_kind,
            "composition": self.composition,
            "focus_op_types": list(self.focus_op_types),
        }


class TransferEngine:
    """Adapt a fully-profiled source device to a target on a budget."""

    def __init__(
        self,
        source_setting: DeviceSetting,
        target_setting: DeviceSetting,
        *,
        family: str = "gbdt",
        seed: int = 0,
        strata: int = 4,
        max_e2e_probes: int = 8,
        source_descriptor: Optional[DeviceDescriptor] = None,
        target_descriptor: Optional[DeviceDescriptor] = None,
        probe_graphs: Optional[Sequence[OpGraph]] = None,
        focus_op_types: Optional[Sequence[str]] = None,
        focus_frac: float = 0.5,
    ):
        if setting_key(source_setting) == setting_key(target_setting):
            raise ValueError(
                "source and target settings resolve to the same key "
                f"({setting_key(source_setting)!r}) — give the target a "
                "distinct DeviceSetting.device tag")
        self.source_setting = source_setting
        self.target_setting = target_setting
        self.family = family
        self.seed = int(seed)
        self.strata = int(strata)
        self.max_e2e_probes = int(max_e2e_probes)
        self.source_descriptor = source_descriptor
        self.target_descriptor = target_descriptor
        self.probe_graphs = list(probe_graphs) if probe_graphs else None
        # Concentration: ``focus_frac`` of the op budget is planned over
        # ``focus_op_types`` alone (the drift monitor's offending cells)
        # before the general coverage pass fills the rest — few-shot
        # recalibration spent where the predictor is known to be wrong.
        self.focus_op_types = (sorted({str(t) for t in focus_op_types})
                               if focus_op_types else [])
        if not 0.0 < focus_frac <= 1.0:
            raise ValueError("focus_frac must be in (0, 1]")
        self.focus_frac = float(focus_frac)
        self._sig_index: Optional[Dict[str, Tuple[OpGraph, Any]]] = None

    # -- target measurement ---------------------------------------------------
    def _signature_index(self) -> Dict[str, Tuple[OpGraph, Any]]:
        if self._sig_index is None:
            if not self.probe_graphs:
                raise ValueError(
                    "target session has no measure_record; pass probe_graphs "
                    "so sampled signatures can be located and measured")
            idx: Dict[str, Tuple[OpGraph, Any]] = {}
            for g in self.probe_graphs:
                gg = (fuse_graph(g)[1] if self.target_setting.is_gpu_like
                      else g)
                for node in gg.nodes:
                    idx.setdefault(op_signature(gg, node), (gg, node))
            self._sig_index = idx
        return self._sig_index

    def _measure(self, session: Any, rec) -> Optional[float]:
        if hasattr(session, "measure_record"):
            return float(session.measure_record(rec, self.target_setting))
        located = self._signature_index().get(rec.signature)
        if located is None:
            log.warning("sampled signature %s… not found in probe graphs; "
                        "skipping", rec.signature[:12])
            return None
        g, node = located
        return float(session.measure_op(g, node, self.target_setting))

    @staticmethod
    def _predicted_op_sum(bank: PredictorBank, arch) -> float:
        """Σ of the bank's per-op predictions over one arch record —
        grouped per op type so each predictor runs once."""
        feats: Dict[str, List[List[float]]] = {}
        for op in arch.ops:
            if op.op_type in bank.predictors:
                feats.setdefault(op.op_type, []).append(op.features)
        total = 0.0
        for op_type, rows in feats.items():
            preds = bank.predictors[op_type].predict(
                np.asarray(rows, dtype=np.float64))
            total += float(np.sum(preds))
        return total

    # -- budgeted op planning -------------------------------------------------
    def _plan_ops(self, source_store: ProfileStore,
                  source_bank: PredictorBank, n_ops: int) -> SamplePlan:
        """The op-measurement plan: one general coverage-first pass —
        unless ``focus_op_types`` concentrates ``focus_frac`` of the
        budget on the offending types first, with the general pass
        filling the remainder (signature-deduped, same determinism)."""
        all_types = set(source_bank.predictors)
        focus = [t for t in self.focus_op_types if t in all_types]
        if not focus or n_ops <= 1:
            return plan_samples(source_store, self.source_setting, n_ops,
                                bank=source_bank, op_types=all_types,
                                strata=self.strata, seed=self.seed)
        n_focus = min(n_ops, max(1, int(round(self.focus_frac * n_ops))))
        plan_f = plan_samples(source_store, self.source_setting, n_focus,
                              bank=source_bank, op_types=set(focus),
                              strata=self.strata, seed=self.seed)
        plan_g = plan_samples(source_store, self.source_setting, n_ops,
                              bank=source_bank, op_types=all_types,
                              strata=self.strata, seed=self.seed)
        merged = SamplePlan(budget=n_ops, seed=self.seed)
        seen = set()
        n_cov = 0
        for src, i, rec in (
                [("f", i, r) for i, r in enumerate(plan_f.records)]
                + [("g", i, r) for i, r in enumerate(plan_g.records)]):
            if len(merged.records) >= n_ops:
                break
            if rec.signature in seen:
                continue
            seen.add(rec.signature)
            merged.records.append(rec)
            cov_n = plan_f.n_coverage if src == "f" else plan_g.n_coverage
            if i < cov_n:
                n_cov += 1
        merged.n_coverage = n_cov
        merged.n_greedy = len(merged.records) - n_cov
        for r in merged.records:
            merged.per_type[r.op_type] = merged.per_type.get(r.op_type, 0) + 1
        return merged

    # -- the adapt flow -------------------------------------------------------
    def adapt(
        self,
        source_store: ProfileStore,
        source_hub: PredictorHub,
        target_session: Any,
        budget_k: int,
    ) -> TransferResult:
        """≤ ``budget_k`` target measurements → a registered target bank."""
        source_bank = source_hub.get(self.source_setting, self.family)
        if source_bank is None:
            raise ValueError(
                f"no trained source bank for "
                f"({setting_key(self.source_setting)}, {self.family}) — "
                f"train the hub on the source store first")
        budget_k = int(budget_k)
        if budget_k < 1:
            raise ValueError("budget_k must be ≥ 1")
        ops_before = getattr(target_session, "measured_ops", 0)
        graphs_before = getattr(target_session, "measured_graphs", 0)

        # Split the budget: a few whole-graph e2e probes calibrate the
        # composition constants (per-op pairs cannot observe dispatch
        # overhead); everything else buys per-op calibration pairs.
        archs = source_store.arch_records(self.source_setting)
        can_probe = hasattr(target_session, "measure_arch_e2e") and archs
        n_e2e = 0
        if can_probe:
            n_e2e = min(self.max_e2e_probes, max(1, budget_k // 8),
                        len(archs), budget_k - 1)
            n_e2e = max(n_e2e, 0)

        plan = self._plan_ops(source_store, source_bank, budget_k - n_e2e)

        # Measure the sampled ops on the target.
        pairs_by_type: Dict[str, List[Tuple[float, float]]] = {}
        for rec in plan.records:
            tgt = self._measure(target_session, rec)
            if tgt is None:
                continue
            pairs_by_type.setdefault(rec.op_type, []).append(
                (rec.latency_s, tgt))

        # Per-type maps; pooled map → descriptor prior as fallbacks.
        maps: Dict[str, LatencyMap] = {}
        for op_type, pairs in pairs_by_type.items():
            maps[op_type] = fit_latency_map([s for s, _ in pairs],
                                            [t for _, t in pairs])
        all_pairs = [p for pairs in pairs_by_type.values() for p in pairs]
        if all_pairs:
            default_map = fit_latency_map([s for s, _ in all_pairs],
                                          [t for _, t in all_pairs])
        else:
            default_map = scale_map(prior_scale(self.source_descriptor,
                                                self.target_descriptor))

        def map_for(op_type: str) -> LatencyMap:
            return maps.get(op_type, default_map)

        # Calibrated per-type predictors around the source bank's models.
        tkey = setting_key(self.target_setting)
        bank = PredictorBank(setting=tkey)
        for op_type, model in source_bank.predictors.items():
            bank.predictors[op_type] = CalibratedPredictor.wrap(
                model, map_for(op_type))

        # Composition: fit on e2e probes when available, else ratio-scale
        # the source constants by the pooled speed ratio.  The probe fit
        # regresses against the calibrated bank's *own* predicted op sums
        # — the quantity it serves — so α also absorbs systematic model
        # bias, exactly like the source-side affine overhead fit does.
        composition = "source"
        if n_e2e > 0:
            # Deterministic spread over graph sizes (quantiles of the
            # kernel count).  Below 4 probes only the ratio-of-sums α
            # is fit, so probes sit at *interior* quantiles (median for
            # one) — at the size extremes the overhead share is atypical
            # and the ratio inherits that bias.  At ≥ 4 the full affine
            # is fit and the extremes make α and c₁ identifiable.
            order = sorted(range(len(archs)),
                           key=lambda i: (archs[i].num_kernels, archs[i].name))
            if n_e2e < 4:
                qs = np.linspace(0, len(order) - 1, n_e2e + 2)[1:-1]
            else:
                qs = np.linspace(0, len(order) - 1, n_e2e)
            probe_idx = sorted({order[int(round(q))] for q in qs})
            e2e_t, sums_t, ks = [], [], []
            for i in probe_idx:
                rec = archs[i]
                e2e_t.append(float(
                    target_session.measure_arch_e2e(rec, self.target_setting)))
                sums_t.append(self._predicted_op_sum(bank, rec))
                ks.append(rec.num_kernels)
            m = len(e2e_t)
            if m >= 4:
                bank.op_sum_scale, bank.overhead, bank.overhead_per_kernel = \
                    estimate_affine(e2e_t, sums_t, ks)
            else:
                # Few probes: a free intercept/slope pair extrapolates
                # through probe noise; the ratio of sums is the robust
                # scale estimator (overheads fold into α).
                bank.op_sum_scale = float(
                    sum(e2e_t) / max(sum(sums_t), _EPS))
            composition = f"probes:{m}"
        else:
            if all_pairs:
                ratio = float(np.exp(np.mean(
                    [np.log(max(t, _EPS)) - np.log(max(s, _EPS))
                     for s, t in all_pairs])))
            else:
                ratio = prior_scale(self.source_descriptor,
                                    self.target_descriptor)
            bank.op_sum_scale = source_bank.op_sum_scale
            bank.overhead = source_bank.overhead * ratio
            bank.overhead_per_kernel = source_bank.overhead_per_kernel * ratio
            composition = "ratio-scaled"
        bank.warm()

        # Verify the budget BEFORE installing anything: an over-budget
        # bank must never be registered (or persisted) for serving.
        n_op = getattr(target_session, "measured_ops", 0) - ops_before
        n_graph = getattr(target_session, "measured_graphs", 0) - graphs_before
        if n_op + n_graph > budget_k:
            raise RuntimeError(
                f"budget violated: {n_op}+{n_graph} measurements > {budget_k}")
        source_hub.register(self.target_setting, self.family, bank,
                            save=bool(source_hub.root))
        result = TransferResult(
            bank=bank, target_key=tkey, family=self.family, budget=budget_k,
            n_op_measurements=n_op, n_e2e_measurements=n_graph, plan=plan,
            map_kinds={t: m.kind for t, m in maps.items()},
            default_map_kind=default_map.kind, composition=composition,
            focus_op_types=list(self.focus_op_types))
        log.info("adapted %s → %s with %d/%d measurements "
                 "(%d op, %d e2e; composition=%s)",
                 setting_key(self.source_setting), tkey,
                 result.n_measurements, budget_k, n_op, n_graph, composition)
        return result
