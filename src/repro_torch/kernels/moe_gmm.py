"""Grouped expert matmul (counterpart of the reference's
``repro.kernels.moe_gmm``): one launch multiplies every expert's rows by
that expert's weights.

    moe_gmm(x, w)  →  x (e, c, d) × w (e, d, f) → (e, c, f)

Products are summed in float32 and the result is returned in x's type,
as the Pallas kernel's float32 accumulator is.  Dispatch is by the device
of ``x``: a CUDA tensor launches the hand-written kernel
(`repro_torch.kernels.moe_gmm_cuda`), a CPU tensor takes
`moe_gmm_plain`.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moe_gmm_cuda

Tensor = torch.Tensor


def moe_gmm_plain(x: Tensor, w: Tensor) -> Tensor:
    """The kernel's function in plain torch, on any device."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def moe_gmm(x: Tensor, w: Tensor) -> Tensor:
    """(e, c, d) × (e, d, f) → (e, c, f) on the device of ``x``."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected x (e, c, d) and w (e, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.is_cuda:
        return moe_gmm_cuda.moe_gmm_cuda(x.contiguous(), w.contiguous())
    return moe_gmm_plain(x, w)
