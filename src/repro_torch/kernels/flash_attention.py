"""Flash attention: online-softmax attention with grouped K/V heads (the
counterpart of the reference's ``repro.kernels.flash_attention``).

    flash_attention(q, k, v, causal=True, q_offset=0)  →  (b, sq, h, d)

q is (b, sq, h, d), k and v are (b, skv, kvh, d) with h a multiple of kvh:
query head ``i`` reads kv head ``i // (h // kvh)``, so grouped-query
attention needs no repeat of K/V (the TPU kernel's equal-heads case is
h == kvh).  Scores are ``q·k / sqrt(d)`` in float32; with ``causal`` key
``j`` is masked for query ``i`` when ``j > i + q_offset``.  Softmax and
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


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, q_offset: int = 0) -> Tensor:
    """The kernel's function in plain torch, on any device: float32 scores,
    softmax and weighted sum, grouped K/V heads, output in q's type."""
    _check_heads(q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        scores = scores.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    q_offset: int = 0) -> Tensor:
    """Attention of q (b, sq, h, d) over k, v (b, skv, kvh, d), on the
    device of ``q``."""
    if q.is_cuda:
        _check_heads(q, k, v)
        return flash_attention_cuda.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            q_offset=q_offset)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
