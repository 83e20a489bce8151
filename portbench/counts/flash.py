"""Causal attention, the ops ``repro_torch::FlashAttention`` (forward) and
``repro_torch::FlashAttentionBackward`` at their call shapes: q
(b, s, h, hd) over k, v (b, s, kvh, hd), with the pairs (query, key ≤
query) that a causal mask keeps (the configurations here have no window).

Forward: S = q·kᵀ and P·v, 4·hd FLOPs a kept pair and head; reads q, k,
v, writes o and each row's float32 log-sum-exp.  Backward: S again (P
is not kept), dP, dV, dQ and dK, 10·hd FLOPs a kept pair and head
(2.5 forwards, the usual count); reads q, k, v, o, dO and the
log-sum-exp, writes dq, dk, dv.  Tensors in the compute type, at the
bfloat16 tensor-core peak.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench.counts import itemsize

OPS = ("repro_torch::FlashAttention", "repro_torch::FlashAttentionBackward")
PEAK = "bf16_flops_per_s"


def kept_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs with key ≤ query, queries at the end of the keys."""
    off = skv - sq
    return sum(min(skv, off + i + 1) for i in range(sq))


def work(op: str, shapes: List[Any], cfg: Dict[str, Any]) -> Tuple[float, float]:
    (b, sq, h, hd), (_, skv, kvh, _) = shapes[0], shapes[1]
    if cfg.get("sliding_window"):
        raise ValueError("a windowed configuration needs its own count")
    pairs = b * h * kept_pairs(sq, skv)
    size = itemsize(cfg["compute_dtype"])
    q_el, kv_el, lse = b * sq * h * hd, b * skv * kvh * hd, 4 * b * sq * h
    if op.endswith("Backward"):
        return (10.0 * hd * pairs,
                float(size * (3 * q_el + 2 * kv_el) + lse + size * (q_el + 2 * kv_el)))
    return 4.0 * hd * pairs, float(size * (2 * q_el + 2 * kv_el) + lse)
