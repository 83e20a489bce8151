"""Inter-chunk SSD recurrence of Mamba2 (counterpart of the reference's
``repro.kernels.ssd_scan``):

    ssd_scan(s_chunk, decay)  →  (h_prev, h_final)
    h_c = decay_c · h_{c-1} + s_c,   h_{-1} = 0

s_chunk is (nc, b, h, p, n), decay (nc, b, h); h_prev (nc, b, h, p, n)
holds the state *before* each chunk (zeros for chunk 0) and h_final
(b, h, p, n) the state after the last.  The state is carried in float32,
as the Pallas kernel's VMEM scratch is, and both outputs come back in
s_chunk's type.

Dispatch is by the device of ``s_chunk``: a CUDA tensor launches the
hand-written kernel (`repro_torch.kernels.ssd_scan_cuda`), a CPU tensor
takes `ssd_scan_plain`.  There is no fallback from one to the other.

Gradients.  When gradients are enabled and s_chunk or decay requires one,
`ssd_scan` goes through `SSDScan` (a `torch.autograd.Function`): its
forward saves h_prev and decay, its backward runs the adjoint recurrence
in reverse (`ssd_scan_backward_plain` states it; the counterpart of the
gradient XLA derives for the reference's ``lax.scan``).  On the card the
backward is the hand-written kernel (``ssd_scan_bwd_launch`` in
``csrc/ssd_scan.cu``), on the host the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ssd_scan_cuda
from repro_torch.kernels._build import refuse_dtensor

Tensor = torch.Tensor


def _check_shapes(s_chunk: Tensor, decay: Tensor) -> None:
    if s_chunk.dim() != 5 or tuple(decay.shape) != tuple(s_chunk.shape[:3]):
        raise ValueError(f"expected s_chunk (nc, b, h, p, n) and decay (nc, b, h); "
                         f"got {tuple(s_chunk.shape)} and {tuple(decay.shape)}")


def ssd_scan_plain(s_chunk: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain torch, on any device: a loop over the
    chunks with a float32 state, ``state * dec + s`` as two rounded ops."""
    _check_shapes(s_chunk, decay)
    state = torch.zeros(s_chunk.shape[1:], dtype=torch.float32,
                        device=s_chunk.device)
    h_prev = torch.empty_like(s_chunk)
    for c in range(s_chunk.shape[0]):
        h_prev[c] = state
        state = state * decay[c].float()[..., None, None] + s_chunk[c].float()
    return h_prev, state.to(s_chunk.dtype)


def ssd_scan_backward_plain(g_prev: Tensor, g_final: Optional[Tensor],
                            h_prev: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """(ds, ddecay) of the scan in plain torch, on any device: the adjoint
    of h_c carried in float32 from G_{nc-1} = g_final (None: zero) down the
    chunks, G_{c-1} = G_c·decay_c + g_prev[c] for c ≥ 1 as two rounded ops
    (the kernel's rule, so ds is bit-equal to it; g_prev[0] would only feed
    the zero initial state's gradient), ds[c] = G_c and
    ddecay[c] = Σ_{p,n} G_c·h_prev[c].  ds comes back in h_prev's type,
    ddecay in decay's."""
    _check_shapes(h_prev, decay)
    if tuple(g_prev.shape) != tuple(h_prev.shape):
        raise ValueError(f"g_prev {tuple(g_prev.shape)} is not h_prev's shape "
                         f"{tuple(h_prev.shape)}")
    nc = h_prev.shape[0]
    grad = (torch.zeros(h_prev.shape[1:], dtype=torch.float32, device=h_prev.device)
            if g_final is None else g_final.float())
    ds = torch.empty_like(h_prev)
    ddecay = torch.empty(decay.shape, dtype=torch.float32, device=h_prev.device)
    for c in range(nc - 1, -1, -1):
        ds[c] = grad
        ddecay[c] = (grad * h_prev[c].float()).sum((-2, -1))
        if c:
            grad = grad * decay[c].float()[..., None, None] + g_prev[c].float()
    return ds, ddecay.to(decay.dtype)


class SSDScan(torch.autograd.Function):
    """The scan with its gradient: the forward saves h_prev and decay, the
    backward is the hand-written kernel on the card and
    `ssd_scan_backward_plain` on the host.  An absent gradient (the SSM
    blocks drop h_final) is zero."""

    @staticmethod
    def forward(ctx, s_chunk: Tensor, decay: Tensor):
        if s_chunk.is_cuda:
            h_prev, h_final = ssd_scan_cuda.ssd_scan_cuda(s_chunk, decay)
        else:
            h_prev, h_final = ssd_scan_plain(s_chunk, decay)
        ctx.save_for_backward(h_prev, decay)
        ctx.set_materialize_grads(False)
        return h_prev, h_final

    @staticmethod
    def backward(ctx, g_prev: Optional[Tensor], g_final: Optional[Tensor]):
        h_prev, decay = ctx.saved_tensors
        g_prev = torch.zeros_like(h_prev) if g_prev is None else g_prev.contiguous()
        if g_final is not None:
            g_final = g_final.contiguous()
        if h_prev.is_cuda:
            return ssd_scan_cuda.ssd_scan_backward_cuda(g_prev, g_final, h_prev, decay)
        return ssd_scan_backward_plain(g_prev, g_final, h_prev, decay)


def ssd_scan(s_chunk: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """(h_prev, h_final) of the inter-chunk recurrence, on the device of
    ``s_chunk``; differentiable (`SSDScan`)."""
    refuse_dtensor("ssd_scan", s_chunk, decay)
    _check_shapes(s_chunk, decay)
    if torch.is_grad_enabled() and (s_chunk.requires_grad or decay.requires_grad):
        return SSDScan.apply(s_chunk.contiguous(), decay.contiguous())
    if s_chunk.is_cuda:
        return ssd_scan_cuda.ssd_scan_cuda(s_chunk.contiguous(), decay.contiguous())
    return ssd_scan_plain(s_chunk, decay)
