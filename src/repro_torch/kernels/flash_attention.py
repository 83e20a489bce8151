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

Gradients.  When gradients are enabled and q, k or v requires one,
`flash_attention` goes through `FlashAttention` (a
`torch.autograd.Function`): its forward saves q, k, v, the output and
each row's log-sum-exp, and its backward computes (dq, dk, dv) from them
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

import torch

from repro_torch.kernels import flash_attention_cuda
from repro_torch.kernels._build import refuse_dtensor

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


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward keeps each row's
    log-sum-exp, the backward is the hand-written kernel on the card and
    `flash_attention_backward_plain` on the host."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                q_offset: int, window: int, softcap: float) -> Tensor:
        kw = {"causal": causal, "q_offset": q_offset, "window": window,
              "softcap": softcap}
        if q.is_cuda:
            o, lse = flash_attention_cuda.flash_attention_cuda(q, k, v, return_lse=True,
                                                               **kw)
        else:
            o = flash_attention_plain(q, k, v, **kw)
            lse = flash_lse_plain(q, k, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_cuda.flash_attention_backward_cuda(
                q, k, v, o, lse, do.contiguous(), **ctx.kw)
        else:
            grads = flash_attention_backward_plain(q, k, v, o, lse, do, **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    q_offset: int = 0, window: int = 0,
                    softcap: float = 0.0) -> Tensor:
    """Attention of q (b, sq, h, d) over k, v (b, skv, kvh, d), on the
    device of ``q``; differentiable (`FlashAttention`)."""
    refuse_dtensor("flash_attention", q, k, v)
    _check_heads(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal, q_offset, window, softcap)
    if q.is_cuda:
        return flash_attention_cuda.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            q_offset=q_offset, window=window, softcap=softcap)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 window=window, softcap=softcap)
