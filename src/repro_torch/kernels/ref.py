"""Plain torch oracles for the ported kernels (twin of the reference's
``repro.kernels.ref``), on whichever device their inputs lie.

Integer products run as float64 matrix products: every int8 × int8
product and every partial sum of the shapes used here is an integer
below 2^53, so the float64 sum is exact in any order, and it runs on the
card, where torch has no integer matrix product.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                        window: int = 0) -> Tensor:
    """q,k,v: (b, s, h, d) same head count (GQA repeat done by caller);
    float32 scores and probabilities, masked with -2e38."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, -2.0e38)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def ssd_scan_ref(s_chunk: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """Inter-chunk SSD recurrence, the state carried in s_chunk's type.

    s_chunk: (nc, b, h, p, n) per-chunk input→state contributions;
    decay:   (nc, b, h) per-chunk cumulative decay.
    Returns (h_prev: (nc, b, h, p, n) state BEFORE each chunk,
             h_final: (b, h, p, n)).
    """
    hstate = torch.zeros(s_chunk.shape[1:], dtype=s_chunk.dtype,
                         device=s_chunk.device)
    h_prev = torch.empty_like(s_chunk)
    for c in range(s_chunk.shape[0]):
        h_prev[c] = hstate
        hstate = (hstate * decay[c][..., None, None] + s_chunk[c]).to(s_chunk.dtype)
    return h_prev, hstate


def moe_gmm_ref(x: Tensor, w: Tensor) -> Tensor:
    """Grouped expert matmul: (e, c, d) × (e, d, f) → (e, c, f), summed in
    float32, returned in ``x.dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def int8_matmul_ref(a_q: Tensor, b_q: Tensor, a_scale: float,
                    b_scale: float) -> Tensor:
    """a_q: (m, k) int8; b_q: (k, n) int8 → (m, n) float32
    ``f32(Σ a·b) · f32(a_scale·b_scale)``."""
    acc = (a_q.double() @ b_q.double()).to(torch.int32)
    return acc.to(torch.float32) * float(np.float32(a_scale * b_scale))


def winograd_conv_ref(x: Tensor, w: Tensor) -> Tensor:
    """Ground truth for Winograd F(2×2,3×3): direct SAME conv, stride 1.

    x: (b, h, w, c); w: (3, 3, c, k) — NHWC / HWIO as the reference.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def extract_winograd_tiles(x: Tensor) -> Tensor:
    """(b,h,w,c) → overlapping 4×4 tiles (b·nt, 4, 4, c), stride 2, SAME pad."""
    b, h, w, c = x.shape
    nh, nw = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (0, 0, 1, 2 * nw - w + 1, 1, 2 * nh - h + 1))
    t = torch.stack([xp[:, i:i + 2 * nh:2] for i in range(4)], dim=3)
    t = torch.stack([t[:, :, j:j + 2 * nw:2] for j in range(4)], dim=4)
    return t.reshape(b * nh * nw, 4, 4, c)


def assemble_winograd_tiles(y: Tensor, b: int, h: int, w: int) -> Tensor:
    """(b·nt, 2, 2, k) → (b, h, w, k)."""
    nh, nw = (h + 1) // 2, (w + 1) // 2
    k = y.shape[-1]
    y = y.reshape(b, nh, nw, 2, 2, k).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * nh, 2 * nw, k)[:, :h, :w, :]
