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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention_cuda

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


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, q_offset: int = 0,
                          window: int = 0, softcap: float = 0.0) -> Tensor:
    """The kernel's function in plain torch, on any device: float32 scores,
    softcap, masks, softmax and weighted sum, grouped K/V heads, output in
    q's type."""
    _check_heads(q, k, v)
    flash_attention_cuda.check_masks(window, softcap)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if causal or window:
        scores = scores.masked_fill(
            hidden_keys(sq, skv, causal=causal, q_offset=q_offset, window=window,
                        device=q.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    q_offset: int = 0, window: int = 0,
                    softcap: float = 0.0) -> Tensor:
    """Attention of q (b, sq, h, d) over k, v (b, skv, kvh, d), on the
    device of ``q``."""
    if q.is_cuda:
        _check_heads(q, k, v)
        return flash_attention_cuda.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            q_offset=q_offset, window=window, softcap=softcap)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 window=window, softcap=softcap)
