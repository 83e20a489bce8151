"""Grouped expert matmul (counterpart of the reference's
``repro.kernels.moe_gmm``): one launch multiplies every expert's rows by
that expert's weights.

    moe_gmm(x, w)  →  x (e, c, d) × w (e, d, f) → (e, c, f)

Products are summed in float32 and the result is returned in x's type,
as the Pallas kernel's float32 accumulator is.  Dispatch is by the device
of ``x``: a CUDA tensor launches the hand-written kernel
(`repro_torch.kernels.moe_gmm_cuda`), a CPU tensor takes
`moe_gmm_plain`.  There is no fallback from one to the other.

Gradients.  When gradients are enabled and x or w requires one, `moe_gmm`
goes through `GroupedMatmul` (a `torch.autograd.Function`) whose two
backward products are grouped matmuls themselves, each through `moe_gmm`
(the same kernel on the card, `moe_gmm_plain` on the host) on contiguous
transposes: dX (e, c, d) = moe_gmm(dY, wᵀ) with wᵀ (e, f, d), and
dW (e, d, f) = moe_gmm(xᵀ, dY) with xᵀ (e, d, c).  Both come out in the
compute type (bfloat16 on the LM path), with float32 sums; autograd then
casts dW back to the float32 parameter it was cast from, as the
reference's ``astype`` gradient does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moe_gmm_cuda
from repro_torch.kernels._build import refuse_dtensor

Tensor = torch.Tensor


def moe_gmm_plain(x: Tensor, w: Tensor) -> Tensor:
    """The kernel's function in plain torch, on any device."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _gmm(x: Tensor, w: Tensor) -> Tensor:
    if x.is_cuda:
        return moe_gmm_cuda.moe_gmm_cuda(x.contiguous(), w.contiguous())
    return moe_gmm_plain(x, w)


class GroupedMatmul(torch.autograd.Function):
    """The GMM with its gradient: both backward products go through the
    GMM itself (`moe_gmm`)."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Tensor) -> Tensor:
        ctx.save_for_backward(x, w)
        return _gmm(x, w)

    @staticmethod
    def backward(ctx, dy: Tensor):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = moe_gmm(x.transpose(1, 2).contiguous(), dy)
        return dx, dw


def moe_gmm(x: Tensor, w: Tensor) -> Tensor:
    """(e, c, d) × (e, d, f) → (e, c, f) on the device of ``x``;
    differentiable (`GroupedMatmul`)."""
    refuse_dtensor("moe_gmm", x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected x (e, c, d) and w (e, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return _gmm(x, w)
