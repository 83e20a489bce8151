"""mamba2-2.7b [ssm]: 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: the attention-kernel selection rules are inapplicable
(DESIGN.md §4); the per-op predictor covers the `ssd_scan` op instead.
Sub-quadratic — runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,             # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
