"""Decoder-only transformer LM, the plain layer stack of the dense and MoE
families (twin of ``repro.models.transformer``).

What differs from the reference, and why:
  * its ``lax.scan`` over stacked layer weights is a Python loop over the
    per-layer `Params` modules of ``params["layers"]``;
  * ``jax.checkpoint`` (remat) saves memory for training's backward pass
    and has no counterpart at inference;
  * ``constrain_seq``, ``gather_layer``, ``pin_layer_stack`` and
    ``constrain_logits`` are sharding constraints that are the identity
    on one device without a mesh, so they are left out;
  * `decode_step` writes the new token's K/V into the cache in place
    (the reference returns new arrays); the cache it returns holds the
    same K/V tensors and a new ``len``.

The gemma2 local/global stack and the VLM cross-attention stack raise
NotImplementedError (ROADMAP A.3): they need window and softcap masks in
the flash kernel, and cross-attention over vision embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.attention import (
    attention_init,
    chunked_attention,
    decode_attention,
    naive_attention,
    qkv_project,
)
from repro_torch.models.layers import (
    Params,
    dense,
    dtype_of,
    embed,
    embed_init,
    mlp_gelu,
    mlp_gelu_init,
    norm_init,
    rms_norm,
    softcap,
    swiglu,
    swiglu_init,
    torch_dtype,
    unembed,
)
from repro_torch.models.moe import moe_ffn, moe_init

Tensor = torch.Tensor


def check_plain_stack(cfg) -> None:
    """Raise for the layer stacks the port does not have yet."""
    if cfg.alt_local_global:
        raise NotImplementedError(
            f"{cfg.name}: the gemma2 local/global stack is not ported "
            f"(ROADMAP A.3: window and softcap in the flash kernel)")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the VLM cross-attention stack is not ported "
            f"(ROADMAP A.3: VLM cross-attention)")


# ---------------------------------------------------------------------------
# Per-layer block
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    if cfg.num_experts:
        mlp = moe_init(gen, cfg)
    elif cfg.mlp_kind == "gelu":
        mlp = mlp_gelu_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    else:
        mlp = swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    return {
        "attn_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "attn": attention_init(gen, cfg),
        "mlp_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "mlp": mlp,
    }


def _ffn(p: Params, h: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """Dense SwiGLU / gelu-MLP / MoE FFN; returns (y, aux_loss)."""
    if cfg.num_experts:
        return moe_ffn(p, h, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.mlp_kind == "gelu":
        return mlp_gelu(p, h, "gelu", dtype_of(cfg)), zero
    return swiglu(p, h, cfg.act, dtype_of(cfg)), zero


def layer_forward(p: Params, x: Tensor, cfg, positions: Tensor,
                  *, window: int = 0) -> Tuple[Tensor, Tensor]:
    """Returns (x, aux_loss) — aux is the MoE load-balance term (0 if dense)."""
    dt = dtype_of(cfg)
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], h, cfg, positions, dt)
    attn_fn = naive_attention if cfg.attention_impl == "naive" else chunked_attention
    o = attn_fn(q, k, v, causal=True, window=window,
                logit_softcap=cfg.attn_logit_softcap,
                **({} if cfg.attention_impl == "naive" else {"q_chunk": cfg.q_chunk}))
    o = o.reshape(x.shape[:-1] + (cfg.num_heads * cfg.head_dim,))
    x = x + dense(p["attn"]["o"], o, dt)
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    y, aux = _ffn(p["mlp"], h, cfg)
    return x + y, aux


def layer_decode(p: Params, x: Tensor, cfg, cache: Dict[str, Tensor], *,
                 window: int = 0) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode. cache: {'k': (b,L,kvh,hd), 'v': ..., 'len': (b,)}"""
    dt = dtype_of(cfg)
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    positions = cache["len"].reshape(-1, 1)          # (b, 1) current position
    q, k_new, v_new = qkv_project(p["attn"], h, cfg, positions, dt)
    idx = cache["len"].reshape(-1)
    k_cache = _scatter_cache(cache["k"], k_new, idx)
    v_cache = _scatter_cache(cache["v"], v_new, idx)
    o = decode_attention(q, k_cache, v_cache, cache_len=idx + 1, window=window,
                         logit_softcap=cfg.attn_logit_softcap)
    o = o.reshape(x.shape[:-1] + (cfg.num_heads * cfg.head_dim,))
    x = x + dense(p["attn"]["o"], o, dt)
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    y, _ = _ffn(p["mlp"], h, cfg)
    return x + y, {"k": k_cache, "v": v_cache, "len": cache["len"]}


def _scatter_cache(cache: Tensor, new: Tensor, idx: Tensor) -> Tensor:
    """Write one token's K/V at per-example positions idx: (b,), in place.

    A position at or past the cache's end writes nothing, as the
    reference's masked select does: the row is written back unchanged.
    """
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = idx.clamp(max=cache.shape[1] - 1)
    inside = (idx < cache.shape[1])[:, None, None]
    cache[rows, at] = torch.where(inside, new[:, 0].to(cache.dtype), cache[rows, at])
    return cache


# ---------------------------------------------------------------------------
# Whole decoder
# ---------------------------------------------------------------------------

def init_decoder(gen: torch.Generator, cfg) -> Params:
    """The port's own init, drawn from ``gen`` on its device."""
    check_plain_stack(cfg)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "final_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
        "layers": [layer_init(gen, cfg) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    return Params(p)


def _head(params: Params, cfg) -> Params:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def decoder_forward(params: Params, tokens: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """tokens: (b, s) integer → (logits (b, s, vocab) float32, moe aux loss)."""
    dt = dtype_of(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens, dt, scale=cfg.scale_embed)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp in params["layers"]:
        x, a = layer_forward(lp, x, cfg, positions, window=cfg.sliding_window)
        aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(_head(params, cfg), x)
    return softcap(logits.float(), cfg.final_logit_softcap), aux


# ---------------------------------------------------------------------------
# KV cache + decode step
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype: str = "bfloat16",
               device="cuda") -> Dict[str, Dict[str, Tensor]]:
    n, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(dtype)
    return {"layers": {
        "k": torch.zeros((n, batch, max_len, kvh, hd), dtype=dt, device=device),
        "v": torch.zeros((n, batch, max_len, kvh, hd), dtype=dt, device=device),
        "len": torch.zeros((n, batch), dtype=torch.int32, device=device),
    }}


def decode_step(params: Params, token: Tensor, cache: Dict[str, Any], cfg
                ) -> Tuple[Tensor, Dict[str, Any]]:
    """token: (b, 1) → (logits (b, vocab) float32, updated cache)."""
    dt = dtype_of(cfg)
    x = embed(params["embed"], token, dt, scale=cfg.scale_embed)
    kv = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        x, _ = layer_decode(lp, x, cfg,
                            {"k": kv["k"][i], "v": kv["v"][i], "len": kv["len"][i]},
                            window=cfg.sliding_window)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(_head(params, cfg), x[:, 0])
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits, {"layers": _bump(kv)}


def _bump(kvc: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {"k": kvc["k"], "v": kvc["v"], "len": kvc["len"] + 1}
