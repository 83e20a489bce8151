"""Whisper-style encoder–decoder backbone [arXiv:2212.04356] (twin of
``repro.models.encdec``).

The audio frontend (mel → conv) is a stub, as in the reference: the
encoder takes precomputed frame embeddings (b, encoder_seq, d_model).
Pre-norm layers with GELU MLPs with biases, sinusoidal encoder positions,
learned decoder positions, and MHA (kv_heads == heads).

The reference's behaviour is kept where it departs from Whisper:
  * the norms are `rms_norm`, not LayerNorm;
  * ``qkv_project`` applies RoPE in the encoder's self-attention and the
    decoder's, on top of the sinusoidal and learned positions;
  * the decode cache is bfloat16 whatever the compute type
    (`init_encdec_cache`'s default);
  * a decoder position past the learned table reads NaN (``jnp.take``'s
    fill mode).

Every prefill attention goes through the flash kernel: the encoder's
non-causal self-attention, the decoder's causal one and the
cross-attention over the encoder's memory, in `decode_step` too (one
query row over the memory).  The decode step's self-attention reads the
cache with plain einsums (`decode_attention`), as the reference does.
Layers are a Python loop over per-layer `Params` (the reference scans a
stacked tree).  `encode` and `decode_train` remat each layer body, as the
reference's ``jax.checkpoint`` does: with gradients enabled, each runs
under `torch.utils.checkpoint.checkpoint`.  The reference's sharding
constraints have no counterpart on one device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.activations import constrain_logits
from repro_torch.distributed.fsdp import gather_layer, local_params, pin_layer_stack
from repro_torch.models.attention import (
    attention_init,
    chunked_attention,
    cross_attention,
    cross_attention_init,
    qkv_project,
)
from repro_torch.models.layers import (
    Params,
    dense,
    dtype_of,
    embed,
    embed_init,
    is_fake,
    mlp_gelu,
    mlp_gelu_init,
    norm_init,
    remat_runner,
    rms_norm,
    sinusoidal_positions,
    torch_dtype,
    unembed,
)
from repro_torch.models.transformer import (
    kv_cache, layer_cache, local_kv, self_attention_decode,
)

Tensor = torch.Tensor

MAX_DECODER_POSITIONS = 32768  # covers the assignment's prefill/decode_32k


def enc_layer_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    return {
        "attn_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "attn": attention_init(gen, cfg),
        "mlp_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "mlp": mlp_gelu_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def dec_layer_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    return {
        "attn_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "attn": attention_init(gen, cfg),
        "xattn_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "xattn": cross_attention_init(gen, cfg),
        "mlp_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "mlp": mlp_gelu_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def init_encdec(gen: torch.Generator, cfg) -> Params:
    """The port's own init, drawn from ``gen`` on its device."""
    n_pos = MAX_DECODER_POSITIONS if cfg.vocab_size > 1024 else 512
    pos = torch.empty((n_pos, cfg.d_model), dtype=torch_dtype(cfg.param_dtype),
                      device=gen.device)
    return Params({
        "enc_layers": [enc_layer_init(gen, cfg) for _ in range(cfg.encoder_layers)],
        "enc_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "dec_embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "dec_pos": pos.normal_(generator=gen) * 0.01,
        "dec_layers": [dec_layer_init(gen, cfg) for _ in range(cfg.num_layers)],
        "dec_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
    })


@functools.lru_cache(maxsize=None)
def _sinusoid_table(seq: int, dim: int, device: torch.device) -> Tensor:
    # Made once per shape and device: a host-to-card copy in every call
    # would wait for the card's queue to drain.
    return torch.as_tensor(sinusoidal_positions(seq, dim), device=device)


def _mlp_block(lp: Params, x: Tensor, cfg) -> Tensor:
    h = rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + mlp_gelu(lp["mlp"], h, "gelu", dtype_of(cfg))


def _enc_layer(lp: Params, x: Tensor, positions: Tensor, cfg) -> Tensor:
    """One encoder layer: non-causal self-attention, then the MLP; its
    leaves gathered first (`fsdp.gather_layer`, the identity off-mesh)."""
    dt = dtype_of(cfg)
    lp = gather_layer(lp, cfg)
    h = rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = qkv_project(lp["attn"], h, cfg, positions, dt)
    o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                          heads=(cfg.num_heads, cfg.num_kv_heads))
    o = o.reshape(x.shape[:-1] + (-1,))
    x = x + dense(lp["attn"]["o"], o, dt)
    return _mlp_block(lp, x, cfg)


def encode(params: Params, frames: Tensor, cfg, *, remat: bool = True) -> Tensor:
    """frames: (b, enc_seq, d_model) stub frontend output → encoder memory.
    With ``remat`` and gradients enabled, each layer runs under a checkpoint.
    The sharding hooks sit where the reference's do."""
    dt = dtype_of(cfg)
    b, s, d = frames.shape
    top = local_params(params)
    table = _sinusoid_table.__wrapped__ if is_fake(frames) else _sinusoid_table
    x = frames.to(dt) + table(s, d, frames.device).to(dt)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    run = remat_runner(remat)
    for lp in pin_layer_stack(params["enc_layers"], cfg):
        x = run(_enc_layer, lp, x, positions, cfg)
    return rms_norm(top["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp: Params, x: Tensor, memory: Tensor, positions: Tensor, cfg
               ) -> Tensor:
    """One decoder layer: causal self-attention, cross-attention over the
    encoder's memory, then the MLP; its leaves gathered first."""
    dt = dtype_of(cfg)
    lp = gather_layer(lp, cfg)
    h = rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = qkv_project(lp["attn"], h, cfg, positions, dt)
    o = chunked_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                          heads=(cfg.num_heads, cfg.num_kv_heads))
    o = o.reshape(x.shape[:-1] + (-1,))
    x = x + dense(lp["attn"]["o"], o, dt)
    h = rms_norm(lp["xattn_norm"], x, cfg.norm_eps)
    x = x + cross_attention(lp["xattn"], h, memory, cfg, dt)
    return _mlp_block(lp, x, cfg)


def decode_train(params: Params, tokens: Tensor, memory: Tensor, cfg, *,
                 remat: bool = True) -> Tensor:
    """Teacher-forced decoder: tokens (b, s) + memory → logits float32.
    With ``remat`` and gradients enabled, each layer runs under a
    checkpoint; ``memory`` is an input of each, so its gradient sums over
    the layers and the encoder is not rerun.  The sharding hooks sit
    where the reference's do."""
    dt = dtype_of(cfg)
    b, s = tokens.shape
    top = local_params(params)
    x = embed(top["dec_embed"], tokens, dt)
    x = x + top.cast("dec_pos", dt)[:s]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    run = remat_runner(remat)
    for lp in pin_layer_stack(params["dec_layers"], cfg):
        x = run(_dec_layer, lp, x, memory, positions, cfg)
    x = rms_norm(top["dec_norm"], x, cfg.norm_eps)
    return constrain_logits(unembed(top["dec_embed"], x), cfg.vocab_size).float()


def init_encdec_cache(cfg, batch: int, max_len: int, dtype: str = "bfloat16",
                      device="cuda") -> Dict[str, Tensor]:
    """The decoder's self-attention cache, stacked on (num_layers,)."""
    return kv_cache(cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                    cfg.head_dim, torch_dtype(dtype), device)


def _decoder_position(params: Params, pos: Tensor, dt: torch.dtype) -> Tensor:
    """Rows ``pos`` (b,) of the learned positions; NaN past the table."""
    table = params.cast("dec_pos", dt)
    n = table.shape[0]
    rows = table[pos.long().clamp(max=n - 1)]
    return rows.masked_fill((pos >= n)[:, None], float("nan"))


def decode_step(params: Params, token: Tensor, cache: Dict[str, Tensor],
                memory: Tensor, cfg) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode with self-attn KV cache + live cross-attn.  On a
    mesh the leaves are gathered layer by layer, ``token`` and ``memory``
    are this rank's rows and the cache its part (`transformer.local_kv`)."""
    dt = dtype_of(cfg)
    top = local_params(params)
    kv, seq_first = local_kv(cache)
    x = embed(top["dec_embed"], token, dt)
    x = x + _decoder_position(top, kv["len"][0], dt)[:, None, :]
    for i, lp in enumerate(params["dec_layers"]):
        lp = gather_layer(lp, cfg)
        h = rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        o, _, _ = self_attention_decode(lp["attn"], h, cfg, layer_cache(kv, i),
                                        seq_first=seq_first)
        x = x + dense(lp["attn"]["o"], o, dt)
        h = rms_norm(lp["xattn_norm"], x, cfg.norm_eps)
        x = x + cross_attention(lp["xattn"], h, memory, cfg, dt)
        x = _mlp_block(lp, x, cfg)
    x = rms_norm(top["dec_norm"], x, cfg.norm_eps)
    logits = unembed(top["dec_embed"], x[:, 0]).float()
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}
