"""Public entry points of the ported kernels (counterpart of the
reference's ``repro.kernels.ops``).

Each runs on the device of its first argument: the hand-written CUDA
kernel for a tensor on the card, the plain torch version for a tensor on
the host.  `repro_torch.core.selection` holds the rules for when the
runtime picks Winograd over a direct convolution.
"""
from __future__ import annotations

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.winograd_conv import winograd_conv2d

__all__ = ["int8_matmul", "winograd_conv2d"]
