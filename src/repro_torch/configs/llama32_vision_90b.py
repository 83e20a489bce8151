"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 — gated cross-attention image layers every 5th
layer; vision frontend STUB (patch embeddings via input_specs())
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,          # 80 self-attn + 20 cross-attn (every 5th)
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    vision_seq=1600,         # stubbed patch-embedding length
    rope_theta=5e5,
)
