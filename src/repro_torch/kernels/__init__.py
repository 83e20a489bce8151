"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``).

Each kernel module builds its library with nvcc at first use, launches
it on a CUDA tensor, and keeps a plain torch version of the same function
for CPU tensors; see `tree_gather_cuda` and `tree_gather`.
"""
