"""whisper-large-v3 [audio]: 32L d_model=1280 20H (GQA kv=20) d_ff=5120
vocab=51866 — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

The audio frontend (mel → conv) is stubbed per the assignment:
`input_specs()` supplies precomputed frame embeddings (1500 frames for
30 s audio).  Whisper uses MHA (kv == heads) with 2-matrix GELU MLPs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_kind="gelu",
    act="gelu",
    tie_embeddings=True,     # whisper ties decoder embed / unembed
)
