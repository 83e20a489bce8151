"""Intra-chunk output of Mamba2's chunked SSD (the quadratic, "attention"
half of state-space duality, arXiv:2405.21060):

    ssd_intra(x, dt, cum, cb)  →  y
    w[t, s] = exp(cum_t − cum_s)·cb[t, s]·dt_s   (s ≤ t; above the diagonal
              the exponent is MASKED_DECAY, −60, set before the exp)
    y[t]    = Σ_s w[t, s]·x[s]

per (batch, chunk) row and head: x and y (b, c, q, h, p), dt and cum
(b, c, q, h), cb = C·Bᵀ (b, c, q, q), which one product makes per layer and
every head shares.  The reference computes this with einsums inside its
``ssd_forward``; it has no kernel of its own.

Dispatch is by the device of ``x``: a CUDA tensor launches the hand-written
float32 kernels (`repro_torch.kernels.ssd_intra_cuda`), which build the
weights tile by tile in shared memory, skip the tiles strictly above the
diagonal and never write w to the card's memory; a CPU tensor takes
`ssd_intra_plain`, the port's code before the kernel, which builds the
(b, c, h, q, q) weights.  There is no fallback from one to the other.

Gradients.  On the card `ssd_intra` calls the `SSDIntra` op (a
`torch.library` op, registered below with its fake rule and FLOP formula),
whose autograd rule runs the `SSDIntraBackward` op: dx, d dt, d cum and d cb
without the (h, q, q) tensors, in a fixed order.  On the host a gradient
is autograd's through `ssd_intra_plain`'s own ops, as before the kernel.
The ops' CPU implementations (`ssd_intra_plain` and
`ssd_intra_backward_plain`, which writes autograd's rules out) let the ops
be checked on the host and are what the card's kernels are held to.

The route follows the device alone, fake tensors included: the dry run's
trace on ``cuda`` counts the op (its FLOP formula, the causal products),
on ``cpu`` the plain version's ops, as the host runs them.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ssd_intra_cuda
from repro_torch.kernels._build import call_op, refuse_dtensor

Tensor = torch.Tensor

# The masked entries of the intra-chunk decay, set BEFORE the exp (above
# the diagonal the decay is positive and could overflow): exp(-60) is
# about 8.8e-27, not zero, as in the reference.
MASKED_DECAY = -60.0


def _check_shapes(x: Tensor, dt: Tensor, cum: Tensor, cb: Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"expected x (b, c, q, h, p), got {tuple(x.shape)}")
    b, c, q, h, _ = x.shape
    for name, t, want in (("dt", dt, (b, c, q, h)), ("cum", cum, (b, c, q, h)),
                          ("cb", cb, (b, c, q, q))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} for x {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")


def ssd_intra_plain(x: Tensor, dt: Tensor, cum: Tensor, cb: Tensor) -> Tensor:
    """y (b, c, q, h, p) in plain torch, on any device: the (b, c, h, q, q)
    weights built whole, then multiplied by x as a batched product over s.
    When a gradient is asked every step is out of place, so autograd can
    follow it; otherwise the weights are one buffer filled in place."""
    _check_shapes(x, dt, cum, cb)
    b, nc, q, h, _ = x.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, cum, cb))
    cum_h = cum.permute(0, 1, 3, 2).contiguous()                     # (b,c,h,Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    cbh = cb[:, :, None]                                             # C_t·B_s
    dts = dt.permute(0, 1, 3, 2)[:, :, :, None, :]                   # dt_s
    if grad:
        w = torch.exp((cum_h[..., :, None] - cum_h[..., None, :])
                      .masked_fill(~tri, MASKED_DECAY)) * cbh * dts
    else:                                # one buffer, filled in place
        w = torch.empty((b, nc, h, q, q), dtype=x.dtype, device=x.device)
        torch.sub(cum_h[..., :, None], cum_h[..., None, :], out=w)
        w.masked_fill_(~tri, MASKED_DECAY).exp_()
        w.mul_(cbh).mul_(dts)
    return (w @ x.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)     # (b,c,t,h,p)


def ssd_intra_backward_plain(dy: Tensor, x: Tensor, dt: Tensor, cum: Tensor,
                             cb: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dx, d dt, d cum, d cb) of `ssd_intra_plain` at the gradient dy of
    its output, in plain torch on any device (autograd's rules written out:
    with u = dw·dt_s, d cb sums u·e over the heads, d dt sums dw·(e·cb)
    over t, and d cum is the row sums less the column sums of (u·cb)·e on
    the kept half)."""
    _check_shapes(x, dt, cum, cb)
    q = x.shape[2]
    cum_h = cum.permute(0, 1, 3, 2)                                  # (b,c,h,Q)
    keep = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    e = torch.exp((cum_h[..., :, None] - cum_h[..., None, :])
                  .masked_fill(~keep, MASKED_DECAY))                 # (b,c,h,t,s)
    cbh = cb[:, :, None]
    dts = dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    ecb = e * cbh
    g = dy.permute(0, 1, 3, 2, 4)                                    # (b,c,h,t,p)
    dw = g @ x.permute(0, 1, 3, 4, 2)                                # (b,c,h,t,s)
    dx = ((ecb * dts).transpose(-1, -2) @ g).permute(0, 1, 3, 2, 4)
    u = dw * dts
    dcb = (u * e).sum(2)
    ddt = (dw * ecb).sum(-2).permute(0, 1, 3, 2)
    dpre = (u * cbh * e).masked_fill(~keep, 0.0)
    dcum = (dpre.sum(-1) - dpre.sum(-2)).permute(0, 1, 3, 2)
    return dx.contiguous(), ddt.contiguous(), dcum.contiguous(), dcb.contiguous()


def causal_pairs(q: int) -> int:
    """(t, s) pairs with s ≤ t in a chunk of q positions."""
    return q * (q + 1) // 2


# `SSDIntra` and `SSDIntraBackward` are `torch.library` ops of the
# ``repro_torch`` namespace: the CUDA implementation is the kernels'
# launch, the CPU one the plain version, the fake one gives the outputs'
# shapes so a trace under `FakeTensorMode` allocates nothing, and the
# forward's autograd rule runs the backward op.  Their FLOP formulas count
# the causal products (2·p a kept pair and head forward: w·x; 4·p backward:
# dx and dw), as flash's count the pairs its masks keep.

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("SSDIntra(Tensor x, Tensor dt, Tensor cum, Tensor cb) -> Tensor")
_LIB.define("SSDIntraBackward(Tensor dy, Tensor x, Tensor dt, Tensor cum, Tensor cb) "
            "-> (Tensor, Tensor, Tensor, Tensor)")


def _intra_cuda(x, dt, cum, cb):
    return ssd_intra_cuda.ssd_intra_cuda(x, dt, cum, cb)


def _intra_cpu(x, dt, cum, cb):
    return ssd_intra_plain(x, dt, cum, cb).contiguous()


def _intra_backward_cuda(dy, x, dt, cum, cb):
    return ssd_intra_cuda.ssd_intra_backward_cuda(dy, x, dt, cum, cb)


def _intra_backward_cpu(dy, x, dt, cum, cb):
    return ssd_intra_backward_plain(dy, x, dt, cum, cb)


_LIB.impl("SSDIntra", _intra_cuda, "CUDA")
_LIB.impl("SSDIntra", _intra_cpu, "CPU")
_LIB.impl("SSDIntraBackward", _intra_backward_cuda, "CUDA")
_LIB.impl("SSDIntraBackward", _intra_backward_cpu, "CPU")


@torch.library.register_fake("repro_torch::SSDIntra", lib=_LIB)
def _intra_fake(x, dt, cum, cb):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.register_fake("repro_torch::SSDIntraBackward", lib=_LIB)
def _intra_backward_fake(dy, x, dt, cum, cb):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (x, dt, cum, cb))


def _intra_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _intra_grad(ctx, dy: Tensor):
    return SSDIntraBackward(dy.contiguous(), *ctx.saved_tensors)


torch.library.register_autograd("repro_torch::SSDIntra", _intra_grad,
                                setup_context=_intra_setup, lib=_LIB)

# The ops by name (`torch.ops.repro_torch.*`).
SSDIntra = torch.ops.repro_torch.SSDIntra
SSDIntraBackward = torch.ops.repro_torch.SSDIntraBackward


@register_flop_formula(SSDIntra)
def _intra_flops(x_shape, dt_shape, cum_shape, cb_shape, *, out_shape=None,
                 **kw) -> int:
    """2·p a causal (t, s) pair and head: the product w·x."""
    b, c, q, h, p = x_shape
    return 2 * p * b * c * h * causal_pairs(q)


@register_flop_formula(SSDIntraBackward)
def _intra_backward_flops(dy_shape, x_shape, dt_shape, cum_shape, cb_shape, *,
                          out_shape=None, **kw) -> int:
    """4·p a causal pair and head: dx = wᵀ·dy and dw = dy·xᵀ."""
    b, c, q, h, p = x_shape
    return 4 * p * b * c * h * causal_pairs(q)


def ssd_intra(x: Tensor, dt: Tensor, cum: Tensor, cb: Tensor) -> Tensor:
    """y (b, c, q, h, p) of the intra-chunk weights, on the device of ``x``;
    differentiable.  A CPU tensor takes `ssd_intra_plain`; any other
    (the card, or fake tensors on it) the `SSDIntra` op."""
    refuse_dtensor("ssd_intra", x, dt, cum, cb)
    if x.device.type == "cpu":
        return ssd_intra_plain(x, dt, cum, cb)
    _check_shapes(x, dt, cum, cb)
    return call_op(SSDIntra, torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, cum, cb)), x.contiguous(),
        dt.contiguous(), cum.contiguous(), cb.contiguous())
