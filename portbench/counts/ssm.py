"""Model FLOPs of a training step of the Mamba2 stack (family ``ssm``).

Forward products per token and layer: in_proj (d → 2·d_inner + 2·n + h),
out_proj (d_inner → d) and the width-w depthwise conv; the chunked SSD
(arXiv:2405.21060, chunk Q): within a chunk, for each (t, s ≤ t) pair the
mask keeps, C_t·B_s (2·n) and its weight on x_s (2·h·p); each token's
share of its chunk's state (2·h·p·n) and its read of the state before
the chunk (2·h·p·n); the chunks' recurrence, 2·h·p·n a chunk; the tied
head, 2·d·V a token.  A training step is three forwards; the layers the
backward recomputes are not counted; elementwise work is not counted.
"""
from __future__ import annotations

from typing import Any, Dict


def forward_flops(cfg: Dict[str, Any], batch: int, seq: int) -> int:
    d, n, w = cfg["d_model"], cfg["ssm_state"], cfg["ssm_conv_width"]
    di = d * cfg["ssm_expand"]
    p = cfg["ssm_head_dim"]
    h = di // p
    nc = max(1, seq // cfg["ssm_chunk"])
    q = seq // nc
    per_token = (2 * d * (2 * di + 2 * n + h) + 2 * di * d + 2 * w * (di + 2 * n)
                 + 2 * h * p * n + 2 * h * p * n)
    per_chunk = (q * (q + 1) // 2) * (2 * n + 2 * h * p) + 2 * h * p * n
    layers = cfg["num_layers"] * (seq * per_token + nc * per_chunk)
    return batch * (layers + seq * 2 * d * cfg["vocab_size"])


def step_flops(cfg: Dict[str, Any], batch: int, seq: int) -> int:
    return 3 * forward_flops(cfg, batch, seq)
