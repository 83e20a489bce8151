"""Architecture + input-shape configuration.

One `ArchConfig` per assigned architecture (exact figures from the
assignment table; `[source]` cited in each config file).  `reduced()`
returns a smoke-test-sized variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads

    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # >0: local attention window
    alt_local_global: bool = False # gemma2: alternate local/global layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    scale_embed: bool = False      # gemma-style sqrt(d) embed scaling

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): shared attention block every k SSM layers
    shared_attn_every: int = 0

    # encoder–decoder (whisper) / VLM cross-attention
    encoder_layers: int = 0
    encoder_seq: int = 0           # stub frontend output length
    cross_attn_every: int = 0      # vlm: cross-attn layer every k layers
    vision_seq: int = 0            # stub patch-embedding length

    act: str = "silu"
    mlp_kind: str = "swiglu"       # swiglu | gelu (2-matrix, starcoder2/whisper)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # FSDP: gather each layer's weights inside the scan body (ZeRO-3);
    # set by the launcher when the fsdp sharding variant is active.
    fsdp_gather: bool = False
    # Sequence parallelism: shard activations' seq dim over `model`
    # between layers (memory lever for long-seq training).
    seq_shard: bool = False

    # attention impl: 'chunked' (flash-style jnp), 'naive', 'pallas'
    attention_impl: str = "chunked"
    q_chunk: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived -----------------------------------------------------------
    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic context path)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def num_params(self) -> int:
        """Approximate parameter count N (used for MODEL_FLOPS = 6·N·D)."""
        d, L = self.d_model, self.num_layers
        h = self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            qkv = d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h) + (self.num_heads * h) * d
            n_mats = 2 if self.mlp_kind == "gelu" else 3
            mlp = n_mats * d * self.d_ff
            per_layer = qkv + mlp
        elif self.family == "moe":
            qkv = d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h) + (self.num_heads * h) * d
            mlp = 3 * d * self.d_ff * self.num_experts + d * self.num_experts
            per_layer = qkv + mlp
        elif self.family in ("ssm", "hybrid"):
            d_in = d * self.ssm_expand
            per_layer = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            if self.family == "hybrid":
                qkv = d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h) + (self.num_heads * h) * d
                per_layer += (qkv + 3 * d * self.d_ff) // max(1, self.shared_attn_every)
        total = emb + L * per_layer
        if self.family == "encdec":
            total += self.encoder_layers * per_layer  # encoder stack
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            total += n_cross * (2 * d * (self.num_kv_heads * h))
        return int(total)

    def active_params(self) -> int:
        """N_active for MoE (6·N_active·D)."""
        if self.family != "moe":
            return self.num_params()
        d, L, h = self.d_model, self.num_layers, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        qkv = d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h) + (self.num_heads * h) * d
        mlp = 3 * d * self.d_ff * self.top_k + d * self.num_experts
        return int(emb + L * (qkv + mlp))

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/structure, tiny sizes."""
        kw: Dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // max(1, self.num_heads))),
            head_dim=32,
            d_ff=256 if self.num_experts == 0 else 64,
            vocab_size=512,
            sliding_window=64 if self.sliding_window else 0,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32 if self.ssm_state else 256,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=64 if self.encoder_seq else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            vision_seq=16 if self.vision_seq else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            q_chunk=64,
            name=self.name + "-reduced",
        )
        if self.alt_local_global:
            kw["num_layers"] = 4  # keep even for local/global pairing
        return replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, and if not, why (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("long_500k requires a sub-quadratic context path; "
                       f"{cfg.name} is a full-attention architecture (skip per assignment)")
    return True, ""
