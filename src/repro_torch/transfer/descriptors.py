"""Fixed-length device descriptors (MAPLE-Edge-style compact identity).

A descriptor summarizes the hardware + scenario axes that move latency:
compute rates, memory bandwidth, core count/clock, executor mode, and
dtype.  It serves two roles in the transfer layer:

  * a *prior* for calibration — when the measurement budget leaves an op
    type with zero sampled pairs and no pooled map, the expected
    source→target latency ratio falls back to the descriptor-derived
    compute-rate ratio (`prior_scale`);
  * a *distance* — `descriptor_distance` ranks candidate source devices
    by similarity when more than one fully-profiled device is available
    ("One Proxy Device Is Enough" picks the closest proxy).

Rate-like fields enter in log space so a 2× compute gap counts the same
at phone scale and TPU scale; boolean/mode axes enter as 0/1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.profiler import DeviceSetting
from repro_torch.core.selection import DeviceProfile

# One entry per descriptor slot, fixed order — the vector length is part
# of the schema (docs/PIPELINE.md § Cross-device transfer).
DESCRIPTOR_FIELDS: Tuple[str, ...] = (
    "log_peak_flops",
    "log_peak_int8_flops",
    "log_hbm_bw",
    "log_link_bw",
    "log_vmem_bytes",
    "log_mxu_dim",
    "log_cores",
    "log_freq_ghz",
    "supports_fusion",
    "supports_winograd",
    "is_gpu_like",
    "is_int8",
)


def _log_or_zero(v: float) -> float:
    """log(v) for positive rates; 0.0 encodes "unknown" (v <= 0)."""
    return math.log(v) if v > 0 else 0.0


@dataclass(frozen=True)
class DeviceDescriptor:
    """One device × setting as a fixed-length feature vector."""

    name: str
    values: Tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.values) != len(DESCRIPTOR_FIELDS):
            raise ValueError(
                f"descriptor needs {len(DESCRIPTOR_FIELDS)} values, "
                f"got {len(self.values)}")

    @property
    def vector(self) -> np.ndarray:
        return np.asarray(self.values, dtype=np.float64)

    def __getitem__(self, field: str) -> float:
        return self.values[DESCRIPTOR_FIELDS.index(field)]

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name,
                "fields": list(DESCRIPTOR_FIELDS),
                "values": [float(v) for v in self.values]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "DeviceDescriptor":
        if list(d["fields"]) != list(DESCRIPTOR_FIELDS):
            raise ValueError(f"descriptor schema mismatch: {d['fields']}")
        return cls(d["name"], tuple(float(v) for v in d["values"]))


def describe(profile: DeviceProfile,
             setting: Optional[DeviceSetting] = None) -> DeviceDescriptor:
    """Descriptor for a `DeviceProfile` under an optional `DeviceSetting`.

    Without a setting, the scenario axes (mode/dtype) default to the
    CPU-like float32 scenario.
    """
    is_gpu_like = bool(setting and setting.is_gpu_like)
    is_int8 = bool(setting and setting.dtype == "int8")
    values = (
        _log_or_zero(profile.peak_flops),
        _log_or_zero(profile.peak_int8_flops),
        _log_or_zero(profile.hbm_bw),
        _log_or_zero(profile.link_bw),
        _log_or_zero(float(profile.vmem_bytes)),
        _log_or_zero(float(profile.mxu_dim)),
        _log_or_zero(float(profile.cores)),
        _log_or_zero(profile.freq_ghz),
        float(profile.supports_fusion),
        float(profile.supports_winograd),
        float(is_gpu_like),
        float(is_int8),
    )
    name = profile.name if setting is None else f"{profile.name}/{setting.name}"
    return DeviceDescriptor(name, values)


def descriptor_distance(a: DeviceDescriptor, b: DeviceDescriptor) -> float:
    """Symmetric L2 over descriptor slots (log-rates → ratio distance)."""
    return float(np.linalg.norm(a.vector - b.vector))


def prior_scale(source: Optional[DeviceDescriptor],
                target: Optional[DeviceDescriptor]) -> float:
    """Expected target/source latency ratio with zero measurements.

    Compute-bound first order: latency scales inversely with peak FLOP/s;
    when either side doesn't report it, fall back to cores × clock, then
    to 1.0 (identity — "assume the proxy device", the only honest answer
    with no information).

    Note the unknown-field encoding is log(v) = 0: a genuinely-1.0 value
    (1 GFLOP/s, 1 core, 1 GHz) is indistinguishable from "unreported" in
    the descriptor, so the fallback compares the combined cores × clock
    rates rather than gating on individual fields — a real 1.0 GHz clock
    then still contributes correctly (its log IS 0).
    """
    if source is None or target is None:
        return 1.0
    s_flops, t_flops = source["log_peak_flops"], target["log_peak_flops"]
    if s_flops != 0.0 and t_flops != 0.0:
        return float(math.exp(s_flops - t_flops))
    s_rate = source["log_cores"] + source["log_freq_ghz"]
    t_rate = target["log_cores"] + target["log_freq_ghz"]
    if s_rate != t_rate:
        return float(math.exp(s_rate - t_rate))
    return 1.0
