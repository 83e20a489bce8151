"""The inter-chunk recurrence of the chunked SSD, the ops
``repro_torch::SSDScan`` and ``repro_torch::SSDScanBackward`` at their
call shapes: states X = (b, h, p, n) in float32, nc chunks.

Forward: h_prev[0] = 0, h_prev[c+1] = decay[c]·h_prev[c] + s[c], h_final
the state after the last chunk; reads s (nc·X) and the decays that
multiply a nonzero state (nc − 1), writes h_prev (nc·X) and h_final (X);
2 FLOPs a state element and chunk.  Backward: reads the gradients of
h_prev past the first chunk (the first only reaches the zero initial
state), of h_final when given, h_prev past the first chunk (the first is
zero) and those decays; writes ds (nc·X) and ddecay (nc decays); 4 FLOPs
a state element and chunk.  Elementwise float32: the CUDA cores' peak;
memory bounds it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

OPS = ("repro_torch::SSDScan", "repro_torch::SSDScanBackward")
PEAK = "fp32_flops_per_s"


def _prod(shape) -> int:
    out = 1
    for v in shape:
        out *= v
    return out


def work(op: str, shapes: List[Any], cfg: Dict[str, Any]) -> Tuple[float, float]:
    if op.endswith("Backward"):
        g_prev, g_final, _, decay = shapes[:4]
        nc, x = g_prev[0], _prod(g_prev[1:])
        bh = _prod(decay[1:])
        reads = (nc - 1) * x + (x if g_final else 0) + (nc - 1) * x + (nc - 1) * bh
        writes = nc * x + nc * bh
        return 4.0 * nc * x, 4.0 * (reads + writes)
    s_chunk, decay = shapes[:2]
    nc, x = s_chunk[0], _prod(s_chunk[1:])
    bh = _prod(decay[1:])
    return 2.0 * nc * x, 4.0 * (nc * x + (nc - 1) * bh + nc * x + x)
