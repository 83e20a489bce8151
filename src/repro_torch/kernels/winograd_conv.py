"""Winograd F(2×2, 3×3) convolution — the paper's §3.2.2 kernel-selection
object (counterpart of the reference's ``repro.kernels.winograd_conv``).

    winograd_conv2d(x, w_or_u)  →  SAME conv, stride 1, NHWC / HWIO

  * Weights are transformed once, offline: U = G·g·Gᵀ → (16, C, K)
    (`transform_weights`), as TFLite does at model-compile time.
  * The overlapping 4×4 input tiles are gathered in torch
    (`repro_torch.kernels.ref.extract_winograd_tiles`) into (T, 16, C).
  * One kernel does, per tile and output channel, the input transform
    BᵀdB, the 16 products with U accumulated over C, and the output
    transform AᵀMA → (T, 4, K); the 2×2 output tiles are assembled in
    torch.

Dispatch is by the device of ``x``: a CUDA tensor launches the
hand-written kernel (`repro_torch.kernels.winograd_conv_cuda`), a CPU
tensor takes `winograd_tiles_plain`.  There is no fallback from one to
the other.  Both compute in full float32; only the order of the sums
differs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import winograd_conv_cuda
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.ref import assemble_winograd_tiles, extract_winograd_tiles

Tensor = torch.Tensor

# Weight transform matrix of F(2x2, 3x3); Bᵀ and Aᵀ are applied as adds.
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]],
              np.float32)


def transform_weights(w: Tensor) -> Tensor:
    """(3,3,C,K) → (16, C, K): U = G g Gᵀ, flattened over the 4×4 grid."""
    g = torch.as_tensor(_G, device=w.device)
    u = torch.einsum("ij,jkcq,lk->ilcq", g, w.float(), g)
    return u.reshape(16, *u.shape[2:]).contiguous()


def _bt_rows(d):
    """Bᵀ·d along an axis of 4 given as a list [d0..d3] → list of 4."""
    return [d[0] - d[2], d[1] + d[2], d[2] - d[1], d[1] - d[3]]


def _at_rows(m):
    """Aᵀ·m along an axis of 4 given as a list [m0..m3] → list of 2."""
    return [m[0] + m[1] + m[2], m[1] - m[2] - m[3]]


def winograd_tiles_plain(tiles: Tensor, u: Tensor) -> Tensor:
    """The kernel's function in plain torch: (T, 16, C) tiles × (16, C, K)
    → (T, 4, K) output tiles (V = BᵀdB, M_e = V_e·U_e, Y = AᵀMA), with
    the kernel's adds for the transforms and no host constants."""
    t, _, c = tiles.shape
    k = u.shape[-1]
    d = tiles.reshape(t, 4, 4, c)
    rows = _bt_rows([d[:, i] for i in range(4)])                      # 4 × (t, 4, c)
    v = torch.stack([torch.stack(_bt_rows([r[:, j] for j in range(4)]), 1)
                     for r in rows], 1)                               # (t, 4, 4, c)
    m = torch.bmm(v.reshape(t, 16, c).transpose(0, 1), u)             # (16, t, k)
    m4 = m.transpose(0, 1).reshape(t, 4, 4, k)
    mrows = _at_rows([m4[:, i] for i in range(4)])                    # 2 × (t, 4, k)
    y = torch.stack([torch.stack(_at_rows([r[:, j] for j in range(4)]), 1)
                     for r in mrows], 1)                              # (t, 2, 2, k)
    return y.reshape(t, 4, k)


def winograd_conv2d(x: Tensor, w: Tensor) -> Tensor:
    """Winograd F(2×2,3×3) SAME conv, stride 1, on the device of ``x``.

    x: (b, h, w, c) float32; w: (3, 3, c, k) weights, or (16, c, k) weights
    already transformed by `transform_weights`.
    """
    u = transform_weights(w) if w.dim() == 4 else w
    b, h, wd, c = x.shape
    k = u.shape[-1]
    tiles = extract_winograd_tiles(x).reshape(-1, 16, c)
    if x.is_cuda:
        refuse_grad("winograd_conv2d", "no training slice of the port runs it",
                    tiles, u)
        y = winograd_conv_cuda.winograd_tiles_cuda(tiles.contiguous(), u)
    else:
        y = winograd_tiles_plain(tiles, u)
    return assemble_winograd_tiles(y.reshape(-1, 2, 2, k), b, h, wd)
