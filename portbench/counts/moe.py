"""Model FLOPs of a training step of the MoE decoder (family ``moe``).

Forward products per token and layer: the q, k, v and o projections, the
router, and the top-k experts' three d × f products (active experts only,
whatever the capacity computes); attention's 4·hd FLOPs per head and
(query, key) pair the causal mask keeps; the tied head, 2·d·V a token.
A training step is three forwards (the backward twice the forward); the
layers the backward recomputes (remat) are not counted.
"""
from __future__ import annotations

from typing import Any, Dict


def forward_flops(cfg: Dict[str, Any], batch: int, seq: int) -> int:
    d, h, kvh, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    proj = 2 * d * h * hd + 2 * 2 * d * kvh * hd + 2 * h * hd * d
    router = 2 * d * cfg["num_experts"]
    experts = cfg["top_k"] * 3 * 2 * d * cfg["d_ff"]
    per_token = cfg["num_layers"] * (proj + router + experts) + 2 * d * cfg["vocab_size"]
    pairs = seq * (seq + 1) // 2
    attention = cfg["num_layers"] * 4 * hd * h * pairs
    return batch * (seq * per_token + attention)


def step_flops(cfg: Dict[str, Any], batch: int, seq: int) -> int:
    return 3 * forward_flops(cfg, batch, seq)
