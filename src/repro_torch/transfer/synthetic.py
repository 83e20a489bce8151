"""Synthetic device pairs: a deterministic "second device" for transfer.

The container has exactly one physical device, but the transfer layer
needs a source→target pair to exercise end to end.  `SyntheticDevice`
derives a target device from the source's measurements through a fixed,
seeded transform:

  * per-op-type log-affine warp  t = e^{a_T} · s^{b_T}  — each op type
    gets its own speed ratio (e^{a_T}) and curvature (b_T ≈ 1), the same
    family real device pairs exhibit (and the calibration layer fits);
  * optional per-signature wiggle (deterministic "measurement
    personality" of the target — cache alignment, scheduler quirks);
  * its own end-to-end composition  e2e = α·Σops + c·K + c₀.

`ReplayProfileSession` is a drop-in `ProfileSession` for that device:
instead of timing kernels it replays the source store through the
device transform, so profiling the target is deterministic, instant,
and counted (`measured_ops` / `measured_graphs`) exactly like real
measurements — which is what budget accounting needs.

Port notes (copy of ``repro.transfer.synthetic``): both sessions hand the
port's `ProfileSession` an explicit ``device="cpu"``.  That is not a
fallback from the card: they override every hook that would run or time
an op (`_time_op`, `_prepare_exec`, `_time_e2e`), so no tensor is ever
placed on a device and their latencies are the same numbers on every
machine.  The base's default (``"cuda"``) would only make them raise on
a host without a card.  `ReplayProfileSession.device` is then the
`SyntheticDevice`, as in the reference; none of the base-class paths
these sessions take reads the torch device.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core.fusion import fuse_graph
from repro_torch.core.ir import OpGraph, OpNode, op_signature
from repro_torch.core.profiler import (ArchRecord, DeviceSetting, OpRecord,
                                 ProfileSession)
from repro_torch.pipeline.store import ProfileStore

_EPS = 1e-12


def _unit(*parts: object) -> float:
    """Deterministic uniform [0, 1) from the hashed parts."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclass(frozen=True)
class SyntheticDevice:
    """A derived target device: seeded per-op-type warp of a source."""

    name: str
    seed: int = 0
    base_scale: float = 2.0        # median target/source speed ratio
    scale_spread: float = 1.0      # per-type ratio spread (log units)
    curvature: float = 0.08        # per-type |b - 1| bound
    noise: float = 0.0             # per-signature log-wiggle amplitude
    op_sum_scale: float = 1.0      # e2e α
    dispatch_s: float = 2e-6       # e2e per-kernel cost
    base_overhead_s: float = 5e-5  # e2e constant

    def type_params(self, op_type: str) -> tuple:
        """(a, b) of the type's log-affine warp — fixed per (seed, type)."""
        u1 = _unit(self.seed, op_type, "scale")
        u2 = _unit(self.seed, op_type, "curve")
        a = math.log(self.base_scale) + self.scale_spread * (u1 - 0.5)
        b = 1.0 + self.curvature * (2.0 * u2 - 1.0)
        return a, b

    def op_latency(self, op_type: str, signature: str,
                   source_s: float) -> float:
        a, b = self.type_params(op_type)
        w = 0.0
        if self.noise:
            w = self.noise * (2.0 * _unit(self.seed, signature, "noise") - 1.0)
        return math.exp(a + b * math.log(max(source_s, _EPS)) + w)

    def e2e(self, op_sum_s: float, num_kernels: int) -> float:
        return (self.op_sum_scale * op_sum_s
                + self.dispatch_s * num_kernels + self.base_overhead_s)

    def warp_shift(self, *, scale: float = 1.0,
                   seed_offset: int = 0) -> "SyntheticDevice":
        """Seeded calibration drift: the same device after its latency
        characteristics moved.

        ``scale`` multiplies every op's latency uniformly (a thermal
        throttle / DVFS shift — systematic bias the drift monitor's
        log-ratio mean sees directly); ``seed_offset`` re-rolls the
        per-type warp parameters (a firmware/runtime change — some op
        types drift much more than others, which is what makes
        `DriftMonitor.worst_cells` targeting meaningful).  Deterministic
        by construction: the drifted device is as replayable as the
        original.
        """
        if scale <= 0:
            raise ValueError("scale must be > 0")
        return replace(self, seed=self.seed + int(seed_offset),
                       base_scale=self.base_scale * float(scale))


class CostModelProfileSession(ProfileSession):
    """Hardware-free ProfileSession: latencies from a roofline model.

    Op latency = dispatch + flops/peak + bytes/bandwidth, read from the
    op's feature vector, times a per-signature jitter — deterministic,
    feature-correlated (predictors can learn it), and instant.  Stands
    in for a profiled *source* device in tests and CI smoke runs where
    wall-clock measurement would be slow and nondeterministic.
    """

    def __init__(self, *, flops_per_s: float = 50e9, bytes_per_s: float = 10e9,
                 dispatch_s: float = 2e-6, jitter: float = 0.05, seed: int = 0,
                 op_sum_scale: float = 1.05, e2e_dispatch_s: float = 3e-6,
                 e2e_base_s: float = 2e-5,
                 store: Optional[ProfileStore] = None, **kw):
        super().__init__(store=store, device="cpu", **kw)
        self.flops_per_s = flops_per_s
        self.bytes_per_s = bytes_per_s
        self.dispatch_s = dispatch_s
        self.jitter = jitter
        self.seed = seed
        self.op_sum_scale = op_sum_scale
        self.e2e_dispatch_s = e2e_dispatch_s
        self.e2e_base_s = e2e_base_s

    def _time_op(self, graph: OpGraph, node: OpNode,
                 setting: DeviceSetting) -> float:
        from repro_torch.core.features import featurize
        names, vals = featurize(graph, node)
        flops = sum(v for n, v in zip(names, vals) if n == "flops")
        nbytes = 4.0 * sum(v for n, v in zip(names, vals)
                           if "size" in n or "bytes" in n)
        lat = self.dispatch_s + flops / self.flops_per_s + nbytes / self.bytes_per_s
        sig = op_signature(graph, node)
        w = 1.0 + self.jitter * (2.0 * _unit(self.seed, sig, "src") - 1.0)
        return lat * w

    def _prepare_exec(self, graph, setting):
        g = fuse_graph(graph)[1] if setting.is_gpu_like else graph
        return g, None

    def _time_e2e(self, runner, g, setting, ops) -> float:
        return (self.op_sum_scale * sum(o.latency_s for o in ops)
                + self.e2e_dispatch_s * len(g.nodes) + self.e2e_base_s)


class ReplayProfileSession(ProfileSession):
    """ProfileSession whose "device" replays a source store via a warp.

    Shares every mechanism of the base class — read-through/write-back
    store, latency cache, measurement counters — and overrides only the
    three timing hooks.  Raises ``KeyError`` for a signature the source
    store never measured (a replayed device can't invent data).
    """

    def __init__(self, reference: ProfileStore, device: SyntheticDevice,
                 source_setting: DeviceSetting, *,
                 store: Optional[ProfileStore] = None, **kw):
        super().__init__(store=store, device="cpu", **kw)
        self.reference = reference
        self.device = device
        self.source_setting = source_setting

    # -- source lookup --------------------------------------------------------
    def _source_record(self, signature: str) -> OpRecord:
        rec = self.reference.get_op(self.source_setting, signature)
        if rec is None:
            raise KeyError(
                f"signature {signature[:12]}… is not in the source store — "
                f"profile it on the source device first")
        return rec

    # -- timing hooks ---------------------------------------------------------
    def _time_op(self, graph: OpGraph, node: OpNode,
                 setting: DeviceSetting) -> float:
        sig = op_signature(graph, node)
        src = self._source_record(sig)
        return self.device.op_latency(node.op_type, sig, src.latency_s)

    def _prepare_exec(self, graph, setting):
        g = fuse_graph(graph)[1] if setting.is_gpu_like else graph
        return g, None

    def _time_e2e(self, runner, g, setting, ops) -> float:
        return self.device.e2e(sum(o.latency_s for o in ops), len(g.nodes))

    # -- record-level measurement (the transfer engine's entry points) -------
    def measure_record(self, rec: OpRecord, setting: DeviceSetting) -> float:
        """Measure one sampled source op on this device (1 measurement).

        Shares `_serve_op_latency`'s cache/store/count bookkeeping with
        `measure_op` — only the latency source differs."""
        return self._serve_op_latency(
            setting, rec.signature, rec.op_type, rec.fused,
            lambda: (rec.feature_names, rec.features),
            lambda: self.device.op_latency(rec.op_type, rec.signature,
                                           rec.latency_s))

    def measure_arch_e2e(self, arch: ArchRecord,
                         setting: DeviceSetting) -> float:
        """End-to-end latency of one source-profiled arch on this device.

        One whole-graph run = one measurement (`measured_graphs`); the
        per-op values inside are not individually observed, matching how
        a real e2e timing run spends budget.
        """
        op_sum = sum(self.device.op_latency(o.op_type, o.signature, o.latency_s)
                     for o in arch.ops)
        self.measured_graphs += 1
        return self.device.e2e(op_sum, arch.num_kernels)
