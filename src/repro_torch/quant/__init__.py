"""Integer-arithmetic inference path (paper §3.1.2, Jacob et al. style)."""
from repro_torch.quant.int8 import (
    build_quant_op_fn,
    dequantize,
    quantize_symmetric,
    requantize,
)

__all__ = ["quantize_symmetric", "dequantize", "requantize", "build_quant_op_fn"]
