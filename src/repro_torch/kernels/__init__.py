"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``).

Each ``.cu`` source is built with nvcc at first use by `_build` (one
hashed library per source).  Each kernel module launches its kernel on a
CUDA tensor and keeps a plain torch version of the same function for CPU
tensors: `tree_gather`, `int8_matmul`, `winograd_conv`,
`flash_attention`, `moe_gmm`, `ssd_scan`; `ops` holds the public entry
points and `ref` the plain oracles.
"""
