"""Flash attention: online-softmax attention with grouped K/V heads (the
counterpart of the reference's ``repro.kernels.flash_attention``).

    flash_attention(q, k, v, causal=True, q_offset=0, window=0, softcap=0.0)
        →  (b, sq, h, d)

q is (b, sq, h, d), k and v are (b, skv, kvh, d) with h a multiple of kvh:
query head ``i`` reads kv head ``i // (h // kvh)``, so grouped-query
attention needs no repeat of K/V (the TPU kernel's equal-heads case is
h == kvh).  The masks and the softcap are those of the reference's model
attention (``repro.models.attention.naive_attention``), which its Pallas
kernel does not have:
  * scores are ``q·k / sqrt(d)`` in float32;
  * a nonzero ``softcap`` maps a score s to ``tanh(s / softcap) · softcap``
    before masking;
  * with ``causal`` key ``j`` is masked for query ``i`` when
    ``j > i + q_offset``;
  * with ``window > 0`` key ``j`` is also masked when
    ``j <= i + q_offset - window``, causal or not.
A query row that every key is masked from averages all of V, as the
reference's softmax over equal masked scores does; the card's kernel
skips the key tiles a window hides and refuses such a row.  Softmax and
the probability-weighted sum of V are float32; the output is in q's type.
On the card, the bfloat16 kernel rounds the probabilities to bfloat16
before the weighted sum (its sums stay float32); see
``csrc/flash_attention.cu``.

Dispatch is by the device of ``q``: a CUDA tensor launches the
hand-written kernel (`repro_torch.kernels.flash_attention_cuda`), a CPU
tensor takes `flash_attention_plain`.  There is no fallback from one to
the other.

Gradients.  `flash_attention` calls the `FlashAttention` op (a
`torch.library` custom op, registered below with its fake and FLOP
rules); when gradients are enabled and q, k or v requires one, its
forward also returns each row's log-sum-exp and saves q, k, v, the
output and that log-sum-exp, and its autograd rule runs the
`FlashAttentionBackward` op, which computes (dq, dk, dv) from them
(P = exp(s - lse), D = Σ dO·O, dS = P ∘ (dP - D), and through a softcap
dS ∘ (1 - (s / softcap)²) on the capped scores s; the counterpart of the
gradient XLA derives for the reference's attention).  On the card both
are hand-written kernels (the forward writing the log-sum-exp, and
``csrc/flash_attention_bwd.cu``); on the host `flash_attention_plain`,
`flash_lse_plain` and `flash_attention_backward_plain`, which the
kernels are held against.  Both take the window and the softcap.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention_cuda
from repro_torch.kernels._build import call_op, refuse_dtensor

Tensor = torch.Tensor

# The masked score of the TPU kernel (kernels/flash_attention.py:30).
NEG_INF = -1.0e30


def _check_heads(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"expected q (b, sq, h, d) and k, v (b, skv, kvh, d) "
                         f"with h a multiple of kvh; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def hidden_keys(sq: int, skv: int, *, causal: bool, q_offset: int, window: int,
                device=None) -> Tensor:
    """(sq, skv) bool: True where key j is masked from query i."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    hidden = torch.zeros((sq, skv), dtype=torch.bool, device=device)
    if causal:
        hidden |= kpos > qpos
    if window:
        hidden |= kpos <= qpos - window
    return hidden


def _capped_scores(q: Tensor, k: Tensor, softcap: float) -> Tensor:
    """Float32 scores (b, kvh, rep, sq, skv): q·k / sqrt(d), then the
    softcap; no mask."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    return scores


def _scores(q: Tensor, k: Tensor, *, causal: bool, q_offset: int, window: int,
            softcap: float) -> Tensor:
    """Float32 scores (b, kvh, rep, sq, skv): q·k / sqrt(d), softcap, masked
    entries at `NEG_INF`."""
    scores = _capped_scores(q, k, softcap)
    if causal or window:
        scores = scores.masked_fill(
            hidden_keys(q.shape[1], k.shape[1], causal=causal, q_offset=q_offset,
                        window=window, device=q.device), NEG_INF)
    return scores


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, q_offset: int = 0,
                          window: int = 0, softcap: float = 0.0) -> Tensor:
    """The kernel's function in plain torch, on any device: float32 scores,
    softcap, masks, softmax and weighted sum, grouped K/V heads, output in
    q's type."""
    _check_heads(q, k, v)
    flash_attention_cuda.check_masks(window, softcap)
    b, sq, h, hd = q.shape
    probs = torch.softmax(_scores(q, k, causal=causal, q_offset=q_offset,
                                  window=window, softcap=softcap), dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_lse_plain(q: Tensor, k: Tensor, *, causal: bool = True,
                    q_offset: int = 0, window: int = 0,
                    softcap: float = 0.0) -> Tensor:
    """Each row's float32 log-sum-exp of its scaled, capped and masked
    scores, (b, h, sq): what the card's forward writes for the backward."""
    b, sq, h, _ = q.shape
    s = _scores(q, k, causal=causal, q_offset=q_offset, window=window,
                softcap=softcap)
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def flash_attention_backward_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                                   lse: Tensor, do: Tensor, *, causal: bool = True,
                                   q_offset: int = 0, window: int = 0,
                                   softcap: float = 0.0):
    """(dq, dk, dv) in the inputs' types, by the backward kernel's formulas
    in plain float32 torch: P = exp(s - lse) from the capped, masked
    scores s (0 where masked), dV = Pᵀ·dO, dP = dO·Vᵀ, D = Σ dO·O over the
    head dim, dS = P ∘ (dP - D), through the softcap
    dS ∘ (1 - (s / softcap)²), dQ = scale·dS·K, dK = scale·dSᵀ·Q, GQA
    summed over each kv head's query heads.  A row that every key is
    masked from takes the forward's average of V (P = 1 / skv) and no dS,
    as the reference's masked softmax gives.  o and lse are the forward's
    output and (b, h, sq) log-sum-exp."""
    _check_heads(q, k, v)
    flash_attention_cuda.check_masks(window, softcap)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep, scale = h // kvh, 1.0 / math.sqrt(hd)
    capped = _capped_scores(q, k, softcap)
    hidden = (hidden_keys(sq, skv, causal=causal, q_offset=q_offset, window=window,
                          device=q.device) if causal or window else None)
    s = capped if hidden is None else capped.masked_fill(hidden, NEG_INF)
    p = torch.exp(s - lse.float().reshape(b, kvh, rep, sq, 1))
    if hidden is not None:
        # Without a host sync: rows that see no key take 1 / skv.
        p = torch.where(hidden.all(-1, keepdim=True), 1.0 / skv,
                        p.masked_fill(hidden, 0.0))
    dog = do.float().reshape(b, sq, kvh, rep, hd)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    delta = (dog * o.float().reshape(b, sq, kvh, rep, hd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap:
        t = capped / softcap
        ds = ds * (1.0 - t * t)
    if hidden is not None:
        ds = ds.masked_fill(hidden, 0.0)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds,
                      q.float().reshape(b, sq, kvh, rep, hd)) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def flash_pairs(sq: int, skv: int, causal: bool, window: int = 0,
                q_offset: int = 0) -> int:
    """(query, key) pairs of one head that the masks keep: query i sits at
    position i + q_offset, the causal mask keeps keys j <= that position
    and the window keys j > position - window; a cross-attention (no
    mask) keeps all sq·skv."""
    import numpy as np

    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


# -- the custom ops ------------------------------------------------------------
#
# `FlashAttention` and `FlashAttentionBackward` are `torch.library` ops of
# the ``repro_torch`` namespace: the CUDA implementation is the kernel's
# launch, the CPU one the plain version, the fake one gives the kernel's
# output shapes (what a trace under `FakeTensorMode` sees, allocating
# nothing), and the forward's autograd rule runs the backward op.  Their
# FLOP formulas (`register_flop_formula`) count the products the kernels
# compute, so `torch.utils.flop_counter.FlopCounterMode` sees them.  The
# LM kernels' ops are defined on `torch.library.Library` fragments, not
# with `torch.library.custom_op`, whose Python wrapper around each call (a
# dynamo guard and an output aliasing check) costs the host µs a call; an
# entry point that needs no gradient calls its op below the autograd step
# (`_build.call_op`).

_NO_LSE = (0,)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("FlashAttention(Tensor q, Tensor k, Tensor v, bool causal, int q_offset, "
            "int window, float softcap, bool with_lse) -> (Tensor, Tensor)")
_LIB.define("FlashAttentionBackward(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor do, bool causal, int q_offset, int window, float softcap) "
            "-> (Tensor, Tensor, Tensor)")


def _flash_forward_cuda(q, k, v, causal, q_offset, window, softcap, with_lse):
    kw = {"causal": causal, "q_offset": q_offset, "window": window,
          "softcap": softcap}
    if with_lse:
        return flash_attention_cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    return (flash_attention_cuda.flash_attention_cuda(q, k, v, **kw),
            q.new_empty(_NO_LSE, dtype=torch.float32))


def _flash_forward_cpu(q, k, v, causal, q_offset, window, softcap, with_lse):
    kw = {"causal": causal, "q_offset": q_offset, "window": window,
          "softcap": softcap}
    o = flash_attention_plain(q, k, v, **kw).contiguous()
    lse = (flash_lse_plain(q, k, **kw).contiguous() if with_lse
           else q.new_empty(_NO_LSE, dtype=torch.float32))
    return o, lse


@torch.library.register_fake("repro_torch::FlashAttention", lib=_LIB)
def _flash_forward_fake(q, k, v, causal, q_offset, window, softcap, with_lse):
    b, sq, h, _ = q.shape
    lse_shape = (b, h, sq) if with_lse else _NO_LSE
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


def _flash_backward_cuda(q, k, v, o, lse, do, causal, q_offset, window, softcap):
    return flash_attention_cuda.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=causal, q_offset=q_offset, window=window,
        softcap=softcap)


def _flash_backward_cpu(q, k, v, o, lse, do, causal, q_offset, window, softcap):
    grads = flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal,
                                           q_offset=q_offset, window=window,
                                           softcap=softcap)
    return tuple(g.contiguous() for g in grads)


@torch.library.register_fake("repro_torch::FlashAttentionBackward", lib=_LIB)
def _flash_backward_fake(q, k, v, o, lse, do, causal, q_offset, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_LIB.impl("FlashAttention", _flash_forward_cuda, "CUDA")
_LIB.impl("FlashAttention", _flash_forward_cpu, "CPU")
_LIB.impl("FlashAttentionBackward", _flash_backward_cuda, "CUDA")
_LIB.impl("FlashAttentionBackward", _flash_backward_cpu, "CPU")

# The ops by name (`torch.ops.repro_torch.*`).
FlashAttention = torch.ops.repro_torch.FlashAttention
FlashAttentionBackward = torch.ops.repro_torch.FlashAttentionBackward


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, q_offset, window, softcap, with_lse = inputs
    if not with_lse:
        # The backward reads the rows' log-sum-exp: `flash_attention` asks
        # for it whenever a gradient may be taken.
        ctx.kw = None
        return
    ctx.save_for_backward(q, k, v, output[0], output[1])
    ctx.kw = (causal, q_offset, window, softcap)


def _flash_grad(ctx, do: Tensor, dlse: Optional[Tensor]):
    if ctx.kw is None:
        raise RuntimeError("FlashAttention was called with with_lse=False; its "
                           "gradient needs the forward's log-sum-exp")
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = FlashAttentionBackward(
        q, k, v, o, lse, do.contiguous(), *ctx.kw)
    return dq, dk, dv, None, None, None, None, None


torch.library.register_autograd("repro_torch::FlashAttention", _flash_grad,
                                setup_context=_flash_setup, lib=_LIB)


def _pairs_of(q_shape, k_shape, causal: bool, q_offset: int, window: int) -> int:
    b, sq, h, _ = q_shape
    return b * h * flash_pairs(sq, k_shape[1], causal, window, q_offset)


@register_flop_formula(FlashAttention)
def _flash_forward_flops(q_shape, k_shape, v_shape, causal, q_offset, window,
                         softcap, with_lse, *, out_shape=None, **kw) -> int:
    """4·d a kept (query, key) pair: S = q·k and the P·V product."""
    return 4 * q_shape[3] * _pairs_of(q_shape, k_shape, causal, q_offset, window)


@register_flop_formula(FlashAttentionBackward)
def _flash_backward_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
                          causal, q_offset, window, softcap, *, out_shape=None,
                          **kw) -> int:
    """14·d a kept pair: the dq pass computes S, dP and dQ, the dk/dv pass
    S, dP, dV and dK (both recompute S and dP: ``csrc/flash_attention_bwd.cu``)."""
    return 14 * q_shape[3] * _pairs_of(q_shape, k_shape, causal, q_offset, window)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    q_offset: int = 0, window: int = 0,
                    softcap: float = 0.0) -> Tensor:
    """Attention of q (b, sq, h, d) over k, v (b, skv, kvh, d), on the
    device of ``q`` through the `FlashAttention` op; differentiable (the
    forward then also keeps the rows' log-sum-exp)."""
    refuse_dtensor("flash_attention", q, k, v)
    _check_heads(q, k, v)
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    o, _ = call_op(FlashAttention, with_lse, q.contiguous(), k.contiguous(),
                   v.contiguous(), bool(causal), int(q_offset), int(window),
                   float(softcap), with_lse)
    return o
