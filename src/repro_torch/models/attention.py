"""Attention: GQA + RoPE + sliding window + softcap; the prefill paths,
cross-attention and the decode path (twin of ``repro.models.attention``).

``naive_attention``, ``chunked_attention`` and ``cross_attention``
compute one function, the flash kernel's
(`repro_torch.kernels.ops.flash_attention`), with the reference's causal
mask, sliding window and logit softcap: on a CUDA tensor they launch the
hand-written kernel, on a CPU tensor its plain version.  Chunking query
rows, as the reference's ``chunked_attention`` does to bound its memory,
changes no row's arithmetic, so the kernel serves both.  In float32, and
on the host in either type, the probabilities stay float32 up to the
weighted sum of V, as in the TPU kernel.  The card's bfloat16 kernel
rounds them to bfloat16 first (the tensor cores' operand type), as the
reference rounds them to the compute type.

``decode_attention`` stays plain torch einsums (`_attend`), as the
reference computes it outside any kernel.  GQA never repeats K/V: query
head i reads kv head i // (h / kvh).

On a mesh the q, k and v projections are column-cut over `model`
(`layers.dense`): a head count that divides the axis keeps this rank's
heads, any other is gathered whole.  The prefill attentions, given the
global head counts (``heads``), run the kernel on this rank's query
heads and the K/V heads they read (`activations.attention_heads`) and
return this rank's heads, which the row-cut o projection takes as its
block of the input.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


from repro_torch.distributed.activations import (
    attention_heads, heads_split, model_max, model_sum, model_whole,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense, dense_init, softcap

Tensor = torch.Tensor

NEG_INF = -2.0e38


def attention_init(gen: torch.Generator, cfg) -> Dict[str, Dict[str, Tensor]]:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": dense_init(gen, d, h * hd, cfg.param_dtype, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, kvh * hd, cfg.param_dtype, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, kvh * hd, cfg.param_dtype, bias=cfg.qkv_bias),
        "o": dense_init(gen, h * hd, d, cfg.param_dtype),
    }


def _split_heads(x: Tensor, hd: int) -> Tensor:
    return x.reshape(x.shape[:-1] + (x.shape[-1] // hd, hd))


def _heads(p: Params, x: Tensor, heads: int, hd: int, dtype) -> Tensor:
    """x's projection split into heads: this rank's heads when the
    projection is column-cut over `model` and ``heads`` divides it."""
    return _split_heads(dense(p, x, dtype, keep_cut=heads_split(heads)), hd)


def qkv_project(p: Params, x: Tensor, cfg, positions: Tensor,
                dtype=None) -> Tuple[Tensor, Tensor, Tensor]:
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _heads(p["q"], x, h, hd, dtype)
    k = _heads(p["k"], x, kvh, hd, dtype)
    v = _heads(p["v"], x, kvh, hd, dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
            logit_softcap: float) -> Tensor:
    """The reference's grouped einsum attention: scores in the operands'
    type then float32, softmax in float32, probabilities rounded to q's
    type before the weighted sum.  ``valid`` broadcasts to
    (b, kvh, rep, sq, skv)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, sq, kvh, h // kvh, hd).to(dt)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(dt)).float()
    scores = softcap(scores / math.sqrt(hd), logit_softcap)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(dt), v.to(dt))
    return out.reshape(b, sq, h, hd)


def naive_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, logit_softcap: float = 0.0,
                    q_offset: int = 0,
                    heads: Optional[Tuple[int, int]] = None) -> Tensor:
    """q (b, sq, h, d) over k, v (b, skv, kvh, d) → (b, sq, h, d).

    On a mesh with a `model` axis the heads divide, the kernel runs on
    this rank's query heads and the K/V heads they read
    (`activations.attention_heads`).  Without ``heads`` q, k and v are
    whole and so is the output (gathered after the kernel); with the
    global (h, kvh) they may be this rank's heads, and the output is this
    rank's heads (see the module docstring)."""
    local = attention_heads(q, k, v, heads)
    if local is None:
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, softcap=logit_softcap)
    o = ops.flash_attention(*local, causal=causal, q_offset=q_offset,
                            window=window, softcap=logit_softcap)
    return o if heads is not None else model_whole(o, 2)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                      window: int = 0, logit_softcap: float = 0.0,
                      q_chunk: int = 512, q_offset: int = 0,
                      heads: Optional[Tuple[int, int]] = None) -> Tensor:
    """The same function as `naive_attention`; ``q_chunk`` bounded the
    reference's memory and has no effect here (the kernel streams K/V)."""
    return naive_attention(q, k, v, causal=causal, window=window,
                           logit_softcap=logit_softcap, q_offset=q_offset,
                           heads=heads)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                     cache_len: Tensor, window: int = 0,
                     logit_softcap: float = 0.0) -> Tensor:
    """Single-token decode vs a (padded) KV cache.

    q: (b, 1, h, hd); caches: (b, max_len, kvh, hd); cache_len: (b,)
    number of valid cache entries (the new token's K/V already written).
    """
    max_len = k_cache.shape[1]
    kpos = torch.arange(max_len, device=q.device)[None, :]
    n = cache_len.reshape(-1, 1)
    valid = kpos < n
    if window:
        valid &= kpos > n - 1 - window
    return _attend(q, k_cache, v_cache, valid[:, None, None, None, :],
                   logit_softcap)


def seq_parallel_decode_attention(q: Tensor, k_block: Tensor, v_block: Tensor, *,
                                  cache_len: Tensor, first: int, window: int = 0,
                                  logit_softcap: float = 0.0) -> Tensor:
    """`decode_attention` over a cache whose sequence is cut over `model`
    (``activations.cache_layout`` "seq"): this rank holds positions
    ``first .. first + k_block.shape[1]`` of every kv head for its batch
    rows.  q (b, 1, h, hd) has every head.  Each rank takes its block's
    softmax statistics; the maximum is combined over the axis, then the
    rescaled sums and weighted values (`activations.model_sum`), the
    partial reductions GSPMD makes of the reference's sequence-cut cache.
    No gradient (decode)."""
    b, sq, h, hd = q.shape
    kvh = k_block.shape[2]
    kpos = first + torch.arange(k_block.shape[1], device=q.device)[None, :]
    n = cache_len.reshape(-1, 1)
    valid = kpos < n
    if window:
        valid &= kpos > n - 1 - window
    dt = torch.promote_types(q.dtype, k_block.dtype)
    qg = q.reshape(b, sq, kvh, h // kvh, hd).to(dt)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_block.to(dt)).float()
    scores = softcap(scores / math.sqrt(hd), logit_softcap)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    top = model_max(scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - top)
    part = torch.einsum("bgrqk,bkgd->bqgrd", p, v_block.float())
    total = model_sum(torch.cat([part.reshape(b, sq, h * hd),
                                 p.sum(-1).permute(0, 3, 1, 2).reshape(b, sq, h)], -1))
    out = total[..., :h * hd].reshape(b, sq, h, hd) / total[..., h * hd:, None]
    return out.to(q.dtype)


def cross_attention_init(gen: torch.Generator, cfg) -> Dict[str, Dict[str, Tensor]]:
    """q from the d_model-wide queries, k and v from a d_model-wide memory
    (the VLM's vision embeddings, Whisper's encoder output)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": dense_init(gen, d, h * hd, cfg.param_dtype),
        "k": dense_init(gen, d, kvh * hd, cfg.param_dtype),
        "v": dense_init(gen, d, kvh * hd, cfg.param_dtype),
        "o": dense_init(gen, h * hd, d, cfg.param_dtype),
    }


def cross_attention(p: Params, x: Tensor, memory: Tensor, cfg,
                    dtype: torch.dtype) -> Tensor:
    """Encoder-decoder / VLM cross-attention (no mask, no RoPE): x
    (b, sq, d) over memory (b, skv, d), through the flash kernel, with
    every product in ``dtype``."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _heads(p["q"], x, h, hd, dtype)
    k = _heads(p["k"], memory, kvh, hd, dtype)
    v = _heads(p["v"], memory, kvh, hd, dtype)
    out = naive_attention(q, k, v, causal=False, heads=(h, kvh))
    out = out.reshape(x.shape[:-1] + (-1,))
    return dense(p["o"], out, dtype)
