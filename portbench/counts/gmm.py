"""One grouped matmul (e, c, d) × (e, d, f) → (e, c, f), the op
``repro_torch::GroupedMatmul`` at its call shapes: 2·e·c·d·f FLOPs, each
operand read once and the product written once, in the configuration's
compute type, at the bfloat16 tensor-core peak."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench.counts import itemsize

OPS = ("repro_torch::GroupedMatmul",)
PEAK = "bf16_flops_per_s"


def work(op: str, shapes: List[Any], cfg: Dict[str, Any]) -> Tuple[float, float]:
    (e, c, d), (_, _, f) = shapes[0], shapes[1]
    size = itemsize(cfg["compute_dtype"])
    return 2.0 * e * c * d * f, float(size * (e * c * d + e * d * f + e * c * f))
