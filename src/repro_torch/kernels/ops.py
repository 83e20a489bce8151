"""Public entry points of the ported kernels (counterpart of the
reference's ``repro.kernels.ops``).

Each runs on the device of its first argument: the hand-written CUDA
kernel for a tensor on the card, the plain torch version for a tensor on
the host.  `repro_torch.core.selection` holds the rules for when the
runtime picks Winograd over a direct convolution; the LM models
(`repro_torch.models`) call `flash_attention` and `moe_gmm`, and the
Mamba2 blocks of the SSM and hybrid families `ssd_scan`.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.ssd_intra import ssd_intra
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.winograd_conv import winograd_conv2d

__all__ = ["flash_attention", "int8_matmul", "moe_gmm", "ssd_intra", "ssd_scan",
           "winograd_conv2d"]
