"""Decoder-only transformer LM: the dense, MoE, gemma2 (local/global) and
VLM (gated cross-attention) stacks (twin of ``repro.models.transformer``).

Variants, as in the reference:
  * dense GQA and MoE: one stack of L layers, ``params["layers"]``;
  * gemma2: L/2 (local, global) layer pairs, ``params["local_layers"]`` and
    ``params["global_layers"]``; local layers attend through the sliding
    window ``cfg.sliding_window``, global ones without it; softcaps and
    the embedding scale come from the config;
  * VLM (llama-3.2-vision): L / ``cross_attn_every`` groups, each of
    ``cross_attn_every − 1`` self-attention layers (``params["self_layers"]``,
    group-major) then one gated cross-attention layer
    (``params["cross_layers"]``: norm → cross-attention over the vision
    embeddings → ``x + tanh(gate) · xa``).  The gate starts at zero, as
    in the reference, so a fresh model's cross-attention adds nothing.

`decoder_stacks` and `layer_order` hold the layout of each variant; init,
forward, cache, decode step and `repro_torch.convert` read it there.

What differs from the reference, and why:
  * its ``lax.scan`` over stacked layer weights is a Python loop over the
    per-layer `Params` modules;
  * ``jax.checkpoint`` (remat) is `torch.utils.checkpoint.checkpoint`
    (non-reentrant) around each layer, applied only while gradients are
    enabled (``remat=True``, the default, as the reference's): the
    backward recomputes a layer's forward, so a training step launches
    each layer's kernels twice forward and once backward, and keeps only
    the layers' inputs between the passes;
  * ``constrain_seq``, ``gather_layer``, ``pin_layer_stack`` and
    ``constrain_logits`` (`repro_torch.distributed`) gather a layer's
    DTensor leaves and cut activations explicitly on a mesh, and are the
    identity on one device without one;
  * `decode_step` writes the new token's K/V into the cache in place
    (the reference returns new arrays); the cache it returns holds the
    same K/V tensors and a new ``len``.  Each stack's cache stays stacked
    on a leading layer axis, as the reference's, and a layer reads its own
    entry of it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed.activations import (
    attention_heads, cache_layout, constrain_logits, constrain_seq, model_whole, unshard_seq,
)
from repro_torch.distributed.fsdp import gather_layer, local_params, pin_layer_stack
from repro_torch.distributed.sharding import local_cache
from repro_torch.models.attention import (
    attention_init,
    chunked_attention,
    cross_attention,
    cross_attention_init,
    decode_attention,
    naive_attention,
    qkv_project,
    seq_parallel_decode_attention,
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
    remat_runner,
    rms_norm,
    softcap,
    swiglu,
    swiglu_init,
    torch_dtype,
    unembed,
)
from repro_torch.models.moe import moe_ffn, moe_init

Tensor = torch.Tensor


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
                heads=(cfg.num_heads, cfg.num_kv_heads),
                **({} if cfg.attention_impl == "naive" else {"q_chunk": cfg.q_chunk}))
    o = o.reshape(x.shape[:-1] + (-1,))
    x = x + dense(p["attn"]["o"], o, dt)
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    y, aux = _ffn(p["mlp"], h, cfg)
    return x + y, aux


def self_attention_decode(p: Params, h: Tensor, cfg, cache: Dict[str, Tensor], *,
                          window: int = 0, seq_first: Optional[int] = None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """The new token's self-attention over its cache (before the output
    projection): its K/V written at each row's position, then attention.
    Returns (o (b, 1, heads · hd), k cache, v cache).

    On a mesh (``p`` is `fsdp.gather_layer`'s view) the query heads are
    this rank's when they divide `model`; the cache holds this rank's kv
    heads (the new token's K/V come from the column-cut projections
    alike), or every kv head for positions ``seq_first ..`` (a cache cut
    along its sequence: `attention.seq_parallel_decode_attention`), or
    every kv head whole, of which this rank's query heads read theirs
    (`activations.attention_heads`)."""
    dt = dtype_of(cfg)
    positions = cache["len"].reshape(-1, 1)          # (b, 1) current position
    q, k_new, v_new = qkv_project(p, h, cfg, positions, dt)
    idx = cache["len"].reshape(-1)
    at = idx if seq_first is None else idx - seq_first
    k_cache = _scatter_cache(cache["k"], k_new, at)
    v_cache = _scatter_cache(cache["v"], v_new, at)
    if seq_first is not None:
        o = seq_parallel_decode_attention(
            model_whole(q, 2) if q.shape[2] != cfg.num_heads else q, k_cache, v_cache,
            cache_len=idx + 1, first=seq_first, window=window,
            logit_softcap=cfg.attn_logit_softcap)
    else:
        local = attention_heads(q, k_cache, v_cache,
                                heads=(cfg.num_heads, cfg.num_kv_heads))
        o = decode_attention(*(local or (q, k_cache, v_cache)), cache_len=idx + 1,
                             window=window, logit_softcap=cfg.attn_logit_softcap)
    return o.reshape(h.shape[:-1] + (-1,)), k_cache, v_cache


def layer_decode(p: Params, x: Tensor, cfg, cache: Dict[str, Tensor], *,
                 window: int = 0, seq_first: Optional[int] = None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode. cache: {'k': (b,L,kvh,hd), 'v': ..., 'len': (b,)}
    (on a mesh, this rank's part: `self_attention_decode`)."""
    dt = dtype_of(cfg)
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    o, k_cache, v_cache = self_attention_decode(p["attn"], h, cfg, cache, window=window,
                                                seq_first=seq_first)
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
    at = idx.clamp(min=0, max=cache.shape[1] - 1)
    inside = ((idx >= 0) & (idx < cache.shape[1]))[:, None, None]
    cache[rows, at] = torch.where(inside, new[:, 0].to(cache.dtype), cache[rows, at])
    return cache


# ---------------------------------------------------------------------------
# Whole decoder
# ---------------------------------------------------------------------------

def _cross_layer_init(gen: torch.Generator, cfg) -> Dict[str, Any]:
    return {"norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
            "xattn": cross_attention_init(gen, cfg),
            "gate": torch.zeros((1,), dtype=torch_dtype(cfg.param_dtype),
                                device=gen.device)}


def decoder_stacks(cfg) -> Dict[str, Tuple[int, ...]]:
    """The decoder's layer stacks: name → the reference's leading
    (stacked) shape.  The port holds one module per entry, unstacked in
    row-major order (the VLM's ``self_layers`` group-major)."""
    if cfg.alt_local_global:
        if cfg.num_layers % 2:
            raise ValueError(f"{cfg.name}: local/global pairs need an even "
                             f"num_layers (got {cfg.num_layers})")
        return {"local_layers": (cfg.num_layers // 2,),
                "global_layers": (cfg.num_layers // 2,)}
    if cfg.cross_attn_every:
        n_groups = cfg.num_layers // cfg.cross_attn_every
        return {"self_layers": (n_groups, cfg.cross_attn_every - 1),
                "cross_layers": (n_groups,)}
    return {"layers": (cfg.num_layers,)}


def layer_order(cfg) -> Iterator[Tuple[str, int, int]]:
    """The decoder's layers in the order they run, as (stack, index in the
    stack, sliding window): gemma2's (local, global) pairs, the VLM's
    groups of self layers each closed by its cross layer, or one plain
    stack."""
    if cfg.alt_local_global:
        for i in range(cfg.num_layers // 2):
            yield "local_layers", i, cfg.sliding_window
            yield "global_layers", i, 0
    elif cfg.cross_attn_every:
        n_groups, n_self = decoder_stacks(cfg)["self_layers"]
        for g in range(n_groups):
            for j in range(n_self):
                yield "self_layers", g * n_self + j, 0
            yield "cross_layers", g, 0
    else:
        for i in range(cfg.num_layers):
            yield "layers", i, cfg.sliding_window


# Each self-attention stack's entry in the K/V cache (the reference's names).
CACHE_OF_STACK = {"layers": "layers", "local_layers": "local",
                  "global_layers": "global", "self_layers": "self"}


def init_decoder(gen: torch.Generator, cfg) -> Params:
    """The port's own init, drawn from ``gen`` on its device."""
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "final_norm": norm_init(cfg.d_model, cfg.param_dtype, gen.device),
    }
    for name, lead in decoder_stacks(cfg).items():
        init = _cross_layer_init if name == "cross_layers" else layer_init
        p[name] = [init(gen, cfg) for _ in range(math.prod(lead))]
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    return Params(p)


def _head(params: Params, cfg) -> Params:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _gated_cross(cp: Params, x: Tensor, vision_embeds: Optional[Tensor], cfg
                 ) -> Tensor:
    """One VLM cross-attention layer: x + tanh(gate) · xattn(norm(x))."""
    if vision_embeds is None:
        raise ValueError(f"{cfg.name}: the cross-attention layers need "
                         f"vision_embeds")
    dt = dtype_of(cfg)
    h = rms_norm(cp["norm"], x, cfg.norm_eps)
    xa = cross_attention(cp["xattn"], h, vision_embeds, cfg, dt)
    return x + torch.tanh(cp["gate"]).to(dt) * xa


def _self_layer(lp: Params, x: Tensor, cfg, positions: Tensor, seq: int,
                window: int) -> Tuple[Tensor, Tensor]:
    """One self-attention layer of the stack: the carry made whole along
    the sequence again and the layer's leaves gathered (both the
    identity off-mesh), then `layer_forward`."""
    x = unshard_seq(x, seq)
    return layer_forward(gather_layer(lp, cfg), x, cfg, positions, window=window)


def _cross_layer(cp: Params, x: Tensor, vision_embeds: Optional[Tensor], cfg,
                 seq: int) -> Tensor:
    return _gated_cross(gather_layer(cp, cfg), unshard_seq(x, seq), vision_embeds, cfg)


def decoder_forward(params: Params, tokens: Tensor, cfg, *,
                    vision_embeds: Optional[Tensor] = None,
                    remat: bool = True) -> Tuple[Tensor, Tensor]:
    """tokens: (b, s) integer → (logits (b, s, vocab) float32, moe aux loss).
    The VLM's ``vision_embeds`` are (b, vision_seq, d_model).  With
    ``remat`` and gradients enabled, each layer runs under
    `torch.utils.checkpoint.checkpoint`; nothing else changes.  The
    reference's sharding hooks (`constrain_seq`, `gather_layer`,
    `pin_layer_stack`, `constrain_logits`) sit where its own do and are
    the identity off-mesh; on a mesh the logits' vocab may come back cut
    over `model` (see `repro_torch.distributed.activations`)."""
    top, x, aux = decoder_trunk(params, tokens, cfg, vision_embeds=vision_embeds,
                                remat=remat)
    return decoder_head(top, x, cfg), aux


def decoder_trunk(params: Params, tokens: Tensor, cfg, *,
                  vision_embeds: Optional[Tensor] = None,
                  remat: bool = True) -> Tuple[Params, Tensor, Tensor]:
    """`decoder_forward` up to the last layer's output: (the top-level
    leaves as the layers compute on them, x (b, s, d), moe aux loss)."""
    dt = dtype_of(cfg)
    b, s = tokens.shape
    top = local_params(params)
    x = embed(top["embed"], tokens, dt, scale=cfg.scale_embed)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    run = remat_runner(remat)
    stacks = {name: pin_layer_stack(params[name], cfg) for name in decoder_stacks(cfg)}
    for stack, i, window in layer_order(cfg):
        lp = stacks[stack][i]
        x = constrain_seq(x, cfg)
        if stack == "cross_layers":
            x = run(_cross_layer, lp, x, vision_embeds, cfg, s)
        else:
            x, a = run(_self_layer, lp, x, cfg, positions, s, window)
            aux = aux + a
    return top, x, aux


def decoder_head(top: Params, x: Tensor, cfg) -> Tensor:
    """The last layer's output → the final norm → the unembedding → the
    softcap: logits (b, s, vocab) float32."""
    x = rms_norm(top["final_norm"], x, cfg.norm_eps)
    logits = constrain_logits(unembed(_head(top, cfg), x), cfg.vocab_size)
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# KV cache + decode step
# ---------------------------------------------------------------------------

def kv_cache(n_layers: int, batch: int, max_len: int, kv_heads: int,
             head_dim: int, dtype: torch.dtype, device) -> Dict[str, Tensor]:
    """One stack's K/V cache: {'k', 'v': (n, b, max_len, kvh, hd), 'len': (n, b)}."""
    shape = (n_layers, batch, max_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((n_layers, batch), dtype=torch.int32, device=device)}


def init_cache(cfg, batch: int, max_len: int, dtype: str = "bfloat16",
               device="cuda") -> Dict[str, Dict[str, Tensor]]:
    def kv(n):
        return kv_cache(n, batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                        torch_dtype(dtype), device)

    return {CACHE_OF_STACK[name]: kv(math.prod(lead))
            for name, lead in decoder_stacks(cfg).items() if name != "cross_layers"}


def layer_cache(kv: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
    """Layer i's entry of a stacked cache (views: writes reach the stack)."""
    return {"k": kv["k"][i], "v": kv["v"][i], "len": kv["len"][i]}


def decode_step(params: Params, token: Tensor, cache: Dict[str, Any], cfg, *,
                vision_embeds: Optional[Tensor] = None
                ) -> Tuple[Tensor, Dict[str, Any]]:
    """token: (b, 1) → (logits (b, vocab) float32, updated cache).

    On a mesh (the ambient one of `repro_torch.launch.mesh.use_mesh`) the
    token is this rank's rows, the parameters DTensors (gathered layer by
    layer, as in `decoder_forward`) and the cache's leaves DTensors laid
    out by `sharding.cache_shardings`; the logits' vocab may come back
    cut over `model`."""
    dt = dtype_of(cfg)
    top = local_params(params)
    x = embed(top["embed"], token, dt, scale=cfg.scale_embed)
    local = {name: local_kv(kv) for name, kv in cache.items()}
    for stack, i, window in layer_order(cfg):
        lp = gather_layer(params[stack][i], cfg)
        if stack == "cross_layers":
            x = _gated_cross(lp, x, vision_embeds, cfg)
        else:
            kv, seq_first = local[CACHE_OF_STACK[stack]]
            x, _ = layer_decode(lp, x, cfg, layer_cache(kv, i), window=window,
                                seq_first=seq_first)
    new_cache = {name: _bump(kv) for name, kv in cache.items()}
    x = rms_norm(top["final_norm"], x, cfg.norm_eps)
    logits = unembed(_head(top, cfg), x[:, 0])
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits, new_cache


def local_kv(kv: Dict[str, Tensor]) -> Tuple[Dict[str, Tensor], Optional[int]]:
    """A K/V cache as this rank's tensors (views: writes reach the
    DTensors' local shards) and the first position of its sequence block
    when the sequence is cut over `model`, else None."""
    if not any(isinstance(t, DTensor) for t in kv.values()):
        return kv, None
    layout = cache_layout(kv["k"])
    kv = local_cache(kv)
    return kv, layout[1] if layout is not None and layout[0] == "seq" else None


def _bump(kvc: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {"k": kvc["k"], "v": kvc["v"], "len": kvc["len"] + 1}
