"""Analytical per-op cost backend (roofline) — the port's copy of the
reference's ``repro.core.cost_model``.

When a device cannot be measured, the paper's "profile then learn"
pipeline still needs latency labels.  This backend produces them
analytically from the op features the featurizers already compute:

    t_op = max(flops / peak, bytes / hbm_bw) + kernel_overhead

— the per-op roofline.  Predictors trained on these labels learn the
cost model (validating the *pipeline*); on a device that is measured,
measured latency over the label says how far each op type runs from its
roofline.

The formulas are the reference's, unchanged: bytes count each input and
output once plus 2 bytes a parameter, and peak rates are derated by
``efficiency=0.85``.  Two things differ, both by device profile:
  * the default profile is the port's card, ``get_device("h100")``;
  * the per-kernel overhead is `kernel_overhead(device)`: for ``h100``
    the floor measured on the card (`H100_KERNEL_OVERHEAD_S`), for every
    other profile the reference's `KERNEL_OVERHEAD_S`, so that given
    ``get_device("tpu_v5e")`` the two packages' labels agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.features import featurize
from repro_torch.core.ir import OpGraph, OpNode
from repro_torch.core.selection import GPU_H100, DeviceProfile, get_device

# The reference's per-kernel overhead, kept for every profile but the
# H100 so that the two packages' labels agree; it is not a time of this
# port.
KERNEL_OVERHEAD_S = 2e-6

# The smallest per-op latency `utils.timing.time_callable` reads through
# the executor's op path on the card: the least op latency of
# chip_smoke.py's float32 op_by_op store (40 graphs at 224), over the op
# types that launch a kernel (an activation op, 5.22 µs); NVIDIA H100
# 80GB HBM3, power limit 700.00 W.  chip_smoke.py's paper method path
# prints the floor it measures beside this value.
H100_KERNEL_OVERHEAD_S = 5.22e-6


def kernel_overhead(device: DeviceProfile) -> float:
    """Seconds a kernel adds beyond its roofline on ``device``."""
    return H100_KERNEL_OVERHEAD_S if device.kind == GPU_H100 else KERNEL_OVERHEAD_S


@dataclass(frozen=True)
class OpCost:
    flops: float
    bytes_accessed: float
    compute_s: float
    memory_s: float
    total_s: float

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


def _op_flops_bytes(graph: OpGraph, node: OpNode) -> Tuple[float, float]:
    names, vals = featurize(graph, node)
    f = dict(zip(names, vals))
    flops = float(f.get("flops", 0.0))
    # Bytes: inputs + outputs + parameters (2 bytes each, the reference's
    # count, kept for parity).
    in_bytes = sum(graph.tensor(t).nbytes for t in node.inputs)
    out_bytes = sum(graph.tensor(t).nbytes for t in node.outputs)
    param_bytes = 2.0 * float(f.get("kernel_size", f.get("param_size", 0.0)))
    explicit = f.get("input_bytes", 0.0) + f.get("output_bytes", 0.0) + f.get("kv_bytes", 0.0)
    return flops, max(float(in_bytes + out_bytes + param_bytes), float(explicit))


def op_cost(graph: OpGraph, node: OpNode,
            device: Optional[DeviceProfile] = None,
            *, dtype: str = "bf16",
            efficiency: float = 0.85) -> OpCost:
    """Roofline cost of one op on `device` (default h100).

    ``efficiency`` derates peak for non-ideal tiling (the reference's
    85%).
    """
    device = device or get_device("h100")
    flops, nbytes = _op_flops_bytes(graph, node)
    peak = device.peak_int8_flops if dtype == "int8" and device.peak_int8_flops else device.peak_flops
    peak = max(peak * efficiency, 1.0)
    bw = max(device.hbm_bw, 1.0)
    c = flops / peak
    m = nbytes / bw
    return OpCost(flops, nbytes, c, m, max(c, m) + kernel_overhead(device))


def graph_cost(graph: OpGraph, device: Optional[DeviceProfile] = None,
               *, dtype: str = "bf16") -> Dict[str, float]:
    """Whole-graph roofline summary."""
    device = device or get_device("h100")
    total_f = total_b = total_t = 0.0
    bound_counts: Dict[str, int] = {"compute": 0, "memory": 0}
    for node in graph.nodes:
        c = op_cost(graph, node, device, dtype=dtype)
        total_f += c.flops
        total_b += c.bytes_accessed
        total_t += c.total_s
        bound_counts[c.bound] += 1
    return {
        "flops": total_f,
        "bytes": total_b,
        "latency_s": total_t,
        "compute_bound_ops": bound_counts["compute"],
        "memory_bound_ops": bound_counts["memory"],
    }


def synthetic_label(graph: OpGraph, node: OpNode,
                    device: Optional[DeviceProfile] = None,
                    *, dtype: str = "bf16", noise: float = 0.0,
                    seed: int = 0) -> float:
    """Latency label for predictor training from the analytical backend.

    Optional multiplicative log-normal noise models measurement variance
    (paper §5.2 observes higher variance with more cores — callers set
    ``noise`` per setting to reproduce that structure).
    """
    base = op_cost(graph, node, device, dtype=dtype).total_s
    if noise > 0:
        rng = np.random.default_rng(seed ^ (node.op_id * 2654435761 % 2**31))
        base *= float(np.exp(rng.normal(0.0, noise)))
    return base
