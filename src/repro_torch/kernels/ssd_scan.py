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

Gradients.  `ssd_scan` calls the `SSDScan` op (a `torch.library` custom
op, registered below with its fake rule): its forward saves h_prev and
decay, and its autograd rule runs the `SSDScanBackward` op, which runs
the adjoint recurrence in reverse (`ssd_scan_backward_plain` states it; the counterpart of the
gradient XLA derives for the reference's ``lax.scan``).  On the card the
backward is the hand-written kernel (``ssd_scan_bwd_launch`` in
``csrc/ssd_scan.cu``), on the host the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ssd_scan_cuda
from repro_torch.kernels._build import call_op, refuse_dtensor

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


# `SSDScan` and `SSDScanBackward` are `torch.library` ops of the
# ``repro_torch`` namespace: the CUDA implementation is the kernel's
# launch, the CPU one the plain version, the fake one gives the kernel's
# outputs (h_prev and h_final; ds and ddecay) so a trace under
# `FakeTensorMode` allocates nothing, and the scan's autograd rule runs
# the backward op.  Neither has a FLOP formula: both are elementwise
# recurrences (a multiply-add a state element and chunk), and
# `FlopCounterMode` counts no elementwise op.

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("SSDScan(Tensor s_chunk, Tensor decay) -> (Tensor, Tensor)")
_LIB.define("SSDScanBackward(Tensor g_prev, Tensor? g_final, Tensor h_prev, "
            "Tensor decay) -> (Tensor, Tensor)")


def _scan_cuda(s_chunk, decay):
    return ssd_scan_cuda.ssd_scan_cuda(s_chunk, decay)


def _scan_cpu(s_chunk, decay):
    return ssd_scan_plain(s_chunk, decay)


def _scan_backward_cuda(g_prev, g_final, h_prev, decay):
    return ssd_scan_cuda.ssd_scan_backward_cuda(g_prev, g_final, h_prev, decay)


def _scan_backward_cpu(g_prev, g_final, h_prev, decay):
    return ssd_scan_backward_plain(g_prev, g_final, h_prev, decay)


_LIB.impl("SSDScan", _scan_cuda, "CUDA")
_LIB.impl("SSDScan", _scan_cpu, "CPU")
_LIB.impl("SSDScanBackward", _scan_backward_cuda, "CUDA")
_LIB.impl("SSDScanBackward", _scan_backward_cpu, "CPU")


@torch.library.register_fake("repro_torch::SSDScan", lib=_LIB)
def _scan_fake(s_chunk, decay):
    return torch.empty_like(s_chunk), s_chunk.new_empty(s_chunk.shape[1:])


@torch.library.register_fake("repro_torch::SSDScanBackward", lib=_LIB)
def _scan_backward_fake(g_prev, g_final, h_prev, decay):
    return torch.empty_like(h_prev), torch.empty_like(decay)


def _scan_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(output[0], inputs[1])
    ctx.set_materialize_grads(False)


def _scan_grad(ctx, g_prev: Optional[Tensor], g_final: Optional[Tensor]):
    """An absent gradient (the SSM blocks drop h_final) is zero."""
    h_prev, decay = ctx.saved_tensors
    g_prev = torch.zeros_like(h_prev) if g_prev is None else g_prev.contiguous()
    if g_final is not None:
        g_final = g_final.contiguous()
    return SSDScanBackward(g_prev, g_final, h_prev, decay)


torch.library.register_autograd("repro_torch::SSDScan", _scan_grad,
                                setup_context=_scan_setup, lib=_LIB)

# The ops by name (`torch.ops.repro_torch.*`).
SSDScan = torch.ops.repro_torch.SSDScan
SSDScanBackward = torch.ops.repro_torch.SSDScanBackward


def ssd_scan(s_chunk: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """(h_prev, h_final) of the inter-chunk recurrence, on the device of
    ``s_chunk`` through the `SSDScan` op; differentiable."""
    refuse_dtensor("ssd_scan", s_chunk, decay)
    _check_shapes(s_chunk, decay)
    return call_op(SSDScan, torch.is_grad_enabled() and (
        s_chunk.requires_grad or decay.requires_grad),
        s_chunk.contiguous(), decay.contiguous())
