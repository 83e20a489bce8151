"""int8 × int8 → int32 matrix product with one float32 rescale (the
counterpart of the reference's ``repro.kernels.int8_matmul``).

    int8_matmul(a_q, b_q, a_scale, b_scale)  →  (m, n) float32
        = f32(Σ_k a_q[m, k]·b_q[k, n]) · f32(a_scale·b_scale)

The kernel wants its weight K-contiguous: `pack_weight` turns a (k, n)
int8 weight into (n, ldb) once, offline (the executor's weights are
constants, as the Winograd transform U is).  `int8_matmul_packed` takes
the packed weight and an optional int32 bias, added to the integer sum
before the scale.

Dispatch is by the device of ``a_q``: a CUDA tensor launches the
hand-written kernel (`repro_torch.kernels.int8_matmul_cuda`), a CPU
tensor takes `int8_matmul_plain`.  There is no fallback from one to the
other.  Both are exact: the integer sum is exact, then one int32 → f32
conversion (round to nearest even) and one f32 multiply, so the kernel
and the plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import int8_matmul_cuda
from repro_torch.kernels._build import refuse_grad

Tensor = torch.Tensor

# The packed weight's row stride is a multiple of this many bytes, so
# the kernel copies its rows to shared memory with 16-byte cp.async.
PACK_ALIGN = 16


def pack_weight(b_q: Tensor) -> Tensor:
    """(k, n) int8 → (n, ldb) int8, K-contiguous, ldb = k rounded up to a
    multiple of `PACK_ALIGN`, zero past k."""
    if b_q.dtype != torch.int8 or b_q.dim() != 2:
        raise ValueError(f"b_q must be a 2-D int8 tensor, got {b_q.dtype} "
                         f"{tuple(b_q.shape)}")
    k, n = b_q.shape
    ldb = -(-max(k, 1) // PACK_ALIGN) * PACK_ALIGN
    bt = torch.zeros((n, ldb), dtype=torch.int8, device=b_q.device)
    bt[:, :k] = b_q.t()
    return bt


def out_scale(a_scale: float, b_scale: float) -> float:
    """The single float32 multiplier ``f32(a_scale·b_scale)``."""
    return float(np.float32(a_scale * b_scale))


def int8_matmul_plain(a_q: Tensor, bt: Tensor, scale: float,
                      bias: Optional[Tensor] = None) -> Tensor:
    """The kernel's function in plain torch, on any device.

    The integer sum runs as a float64 product: every partial sum is an
    integer below 2^53, so it is exact (torch has no integer matrix
    product on the card)."""
    k = a_q.shape[1]
    acc = (a_q.double() @ bt[:, :k].double().t()).to(torch.int32)
    if bias is not None:
        acc = acc + bias
    return acc.to(torch.float32) * scale


def int8_matmul_packed(a_q: Tensor, bt: Tensor, scale: float,
                       bias: Optional[Tensor] = None) -> Tensor:
    """(m, k) int8 × packed weight [+ (n,) int32 bias] → (m, n) float32,
    on the device of ``a_q``; ``scale`` is a float32 value.  ``a_q`` may
    be a row-strided view (unit column stride), as the executor's
    im2col patches are."""
    if a_q.is_cuda:
        refuse_grad("int8_matmul", "no training slice of the port runs it", a_q, bt,
                    bias)
        return int8_matmul_cuda.int8_matmul_cuda(a_q, bt, scale, bias)
    return int8_matmul_plain(a_q, bt, scale, bias)


def int8_matmul(a_q: Tensor, b_q: Tensor, a_scale: float,
                b_scale: float) -> Tensor:
    """a_q: (m, k) int8, b_q: (k, n) int8 → (m, n) float32 a_scale·b_scale·Σ."""
    if a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    return int8_matmul_packed(a_q, pack_weight(b_q), out_scale(a_scale, b_scale))
