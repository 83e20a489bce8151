"""Grouped expert matmul (counterpart of the reference's
``repro.kernels.moe_gmm``): one launch multiplies every expert's rows by
that expert's weights.

    moe_gmm(x, w)  →  x (e, c, d) × w (e, d, f) → (e, c, f)

Products are summed in float32 and the result is returned in x's type,
as the Pallas kernel's float32 accumulator is.  Dispatch is by the device
of ``x``: a CUDA tensor launches the hand-written kernel
(`repro_torch.kernels.moe_gmm_cuda`), a CPU tensor takes
`moe_gmm_plain`.  There is no fallback from one to the other.

Gradients.  `moe_gmm` calls the `GroupedMatmul` op (a `torch.library`
custom op, registered below with its fake and FLOP rules), whose
autograd rule's two backward products are grouped matmuls themselves,
each through `moe_gmm` (the same kernel on the card, `moe_gmm_plain` on the host) on contiguous
transposes: dX (e, c, d) = moe_gmm(dY, wᵀ) with wᵀ (e, f, d), and
dW (e, d, f) = moe_gmm(xᵀ, dY) with xᵀ (e, d, c).  Both come out in the
compute type (bfloat16 on the LM path), with float32 sums; autograd then
casts dW back to the float32 parameter it was cast from, as the
reference's ``astype`` gradient does.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import moe_gmm_cuda
from repro_torch.kernels._build import call_op, refuse_dtensor

Tensor = torch.Tensor


def moe_gmm_plain(x: Tensor, w: Tensor) -> Tensor:
    """The kernel's function in plain torch, on any device."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


# `GroupedMatmul` is a `torch.library` op of the ``repro_torch`` namespace:
# the CUDA implementation is the kernel's launch, the CPU one the plain
# version, the fake one gives the kernel's output shape (a trace under
# `FakeTensorMode` allocates nothing), the autograd rule is the two
# backward products above, and the FLOP formula counts 2·e·c·d·f.

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("GroupedMatmul(Tensor x, Tensor w) -> Tensor")


def _gmm_cuda(x, w):
    return moe_gmm_cuda.moe_gmm_cuda(x.contiguous(), w.contiguous())


def _gmm_cpu(x, w):
    return moe_gmm_plain(x, w)


_LIB.impl("GroupedMatmul", _gmm_cuda, "CUDA")
_LIB.impl("GroupedMatmul", _gmm_cpu, "CPU")


@torch.library.register_fake("repro_torch::GroupedMatmul", lib=_LIB)
def _gmm_fake(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


def _gmm_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _gmm_grad(ctx, dy: Tensor):
    """Both backward products go through the GMM itself (`moe_gmm`)."""
    x, w = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = moe_gmm(dy, w.transpose(1, 2).contiguous())
    if ctx.needs_input_grad[1]:
        dw = moe_gmm(x.transpose(1, 2).contiguous(), dy)
    return dx, dw


torch.library.register_autograd("repro_torch::GroupedMatmul", _gmm_grad,
                                setup_context=_gmm_setup, lib=_LIB)

# The op by name (`torch.ops.repro_torch.GroupedMatmul`).
GroupedMatmul = torch.ops.repro_torch.GroupedMatmul


@register_flop_formula(GroupedMatmul)
def _gmm_flops(x_shape, w_shape, *, out_shape=None, **kw) -> int:
    e, c, d = x_shape
    return 2 * e * c * d * w_shape[2]


def _gmm(x: Tensor, w: Tensor) -> Tensor:
    return call_op(GroupedMatmul, torch.is_grad_enabled()
                   and (x.requires_grad or w.requires_grad), x, w)


def moe_gmm(x: Tensor, w: Tensor) -> Tensor:
    """(e, c, d) × (e, d, f) → (e, c, f) on the device of ``x`` through the
    `GroupedMatmul` op; differentiable."""
    refuse_dtensor("moe_gmm", x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected x (e, c, d) and w (e, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return _gmm(x, w)
