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
The kernel has no backward yet: on the card, an input that requires a
gradient raises (`_build.refuse_grad`); the plain version stays
differentiable.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ssd_scan_cuda
from repro_torch.kernels._build import refuse_grad

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


def ssd_scan(s_chunk: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """(h_prev, h_final) of the inter-chunk recurrence, on the device of
    ``s_chunk``."""
    _check_shapes(s_chunk, decay)
    if s_chunk.is_cuda:
        refuse_grad("ssd_scan", "the SSM and hybrid training slice", s_chunk, decay)
        return ssd_scan_cuda.ssd_scan_cuda(s_chunk.contiguous(), decay.contiguous())
    return ssd_scan_plain(s_chunk, decay)
