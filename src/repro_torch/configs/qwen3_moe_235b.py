"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4)
d_ff=1536 (per expert) vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=1e6,
)
